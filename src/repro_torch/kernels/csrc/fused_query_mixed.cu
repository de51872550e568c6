// K1's cross-format instantiations fused_query_kernel<TR, QR>, QR != TR
// (fused_query.cuh: a query batch in another format than the corpus's),
// built beside fused_query.cu's same-format ones:
//   <kDense, 0>, <kDense, 16>   CP / TT queries over dense rows
//   <0, kDense>, <4 | 16, kDense>  dense queries over CP / TT rows
//   <4 | 16, 0>, <0, 4 | 16>    CP queries over TT rows, TT over CP rows
// (a TT corpus's rank bound 4 or 16, a TT query's 4 over short CP rows or
// 16).

#include "fused_query.cuh"

// The pairs this file holds, (TR, QR), are fused_query.cuh's K1_MIXED_PAIRS.

int fused_query_mixed_launch(int tr, int qr, const K1Args& a, size_t smem,
                             cudaStream_t stream) {
#define K1_LAUNCH(TR, QR) \
  if (tr == TR && qr == QR) return launch<TR, QR>(a, smem, stream);
  K1_MIXED_PAIRS(K1_LAUNCH)
#undef K1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

int fused_query_mixed_occupancy(int tr, int qr, size_t smem, int* out) {
#define K1_OCCUPANCY(TR, QR) \
  if (tr == TR && qr == QR) return occupancy<TR, QR>(smem, out);
  K1_MIXED_PAIRS(K1_OCCUPANCY)
#undef K1_OCCUPANCY
  return (int)cudaErrorInvalidValue;
}
