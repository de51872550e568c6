// K1's sampling instantiations fused_query_kernel<TR, QR, true> of the
// cross-format pairs (QR != TR), built beside fused_query_sample.cu's
// same-format ones.

#include "fused_query.cuh"

// The pairs this file holds, (TR, QR), are fused_query.cuh's
// K1_MIXED_PAIRS.

int fused_query_sample_mixed_launch(int tr, int qr, const K1Args& a,
                                    size_t smem, cudaStream_t stream) {
#define K1_LAUNCH(TR, QR) \
  if (tr == TR && qr == QR) return launch<TR, QR, true>(a, smem, stream);
  K1_MIXED_PAIRS(K1_LAUNCH)
#undef K1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

int fused_query_sample_mixed_occupancy(int tr, int qr, size_t smem,
                                       int* out) {
#define K1_OCCUPANCY(TR, QR) \
  if (tr == TR && qr == QR) return occupancy<TR, QR, true>(smem, out);
  K1_MIXED_PAIRS(K1_OCCUPANCY)
#undef K1_OCCUPANCY
  return (int)cudaErrorInvalidValue;
}
