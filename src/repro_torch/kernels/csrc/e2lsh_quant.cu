// K7: E2LSH floor-quantize, floor((v + b) / w) -> int32, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/e2lsh_quant.py::_e2lsh_quant_kernel
// (the pl.pallas_call in e2lsh_quant_pallas, wrapped by
// repro/kernels/ops.py's e2lsh_quantize). For values (B, K) float32 and
// offsets (K,) it stores int32 codes (B, K).
//
// Rounding: v + b is __fadd_rn and the division by w is __fdiv_rn, IEEE
// round-to-nearest, never a multiply by 1/w. This follows the reference's
// own oracle (kernels/ref.py e2lsh_quant_ref), core/lsh.py e2lsh_discretize
// and the fused epilogues (epilogue.cuh); the Pallas kernel multiplies by
// 1/w, which floors differently next to bucket edges for widths that are
// not powers of two (ROADMAP.md, R4).
//
// What bounds it on the H100: bytes. It reads 4 bytes a value and writes 4
// a code; an add, a divide and a floor per value are far below the
// arithmetic limits.
//
// What the design does about it: one thread per value, consecutive threads
// on consecutive values, so loads and stores are coalesced; the (K,)
// offsets stay in L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void e2lsh_quant_kernel(const float* __restrict__ v,     // (B, K)
                                   const float* __restrict__ offs,  // (K,)
                                   int* __restrict__ out,           // (B, K)
                                   long long n, int K, float w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = (int)(i % K);
  out[i] = (int)floorf(__fdiv_rn(__fadd_rn(v[i], __ldg(offs + k)), w));
}

}  // namespace

extern "C" int e2lsh_quant_launch(const float* v, const float* offs, int* out,
                                  long long B, int K, float w, void* stream) {
  const long long n = B * K;
  const int threads = 256;
  e2lsh_quant_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(v, offs, out, n, K,
                                                            w);
  return (int)cudaGetLastError();
}
