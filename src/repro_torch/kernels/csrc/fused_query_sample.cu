// K1's sampling instantiations fused_query_kernel<TR, QR, true> (the query
// modes "uniform" and "weighted": fused_query.cuh's SAMPLE) of the
// same-format pairs, and the dispatch to every pair's; the cross-format
// pairs' are in fused_query_sample_mixed.cu. Built beside the top-k
// instantiations, so that those compile as they did without this mode, and
// in two files, so that nvcc builds them side by side. They serve K1 and
// K1s alike (the launch's segment table says which).

#include "fused_query.cuh"

// The pairs this file holds, (TR, QR), are fused_query.cuh's K1_SAME_PAIRS.

int fused_query_sample_launch(int tr, int qr, const K1Args& a, size_t smem,
                              cudaStream_t stream) {
  if (tr != qr)
    return fused_query_sample_mixed_launch(tr, qr, a, smem, stream);
#define K1_LAUNCH(TR, QR) \
  if (tr == TR && qr == QR) return launch<TR, QR, true>(a, smem, stream);
  K1_SAME_PAIRS(K1_LAUNCH)
#undef K1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

int fused_query_sample_occupancy(int tr, int qr, size_t smem, int* out) {
  if (tr != qr) return fused_query_sample_mixed_occupancy(tr, qr, smem, out);
#define K1_OCCUPANCY(TR, QR) \
  if (tr == TR && qr == QR) return occupancy<TR, QR, true>(smem, out);
  K1_SAME_PAIRS(K1_OCCUPANCY)
#undef K1_OCCUPANCY
  return (int)cudaErrorInvalidValue;
}
