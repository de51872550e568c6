// K3: batch-native fused CP x CP hashing for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cp_gram.py::_cp_hash_kernel (the
// pl.pallas_call in cp_gram_pallas) together with its fused
// repro/kernels/epilogues.py::apply_epilogue tail. For a batch of CP inputs
// X_z and the L*K stacked CP projections P_{l,k} it computes
//
//     v[z, l, k] = scale * sum_{r,q} prod_n (X_{z,n}^T P_{(l,k),n})[r, q]
//
// and applies the epilogue in registers (csrc/epilogue.cuh, shared with K4),
// so only the epilogue's output is stored: raw values, E2LSH codes, SRP
// bits, uint32 radix keys or packed SRP bits.
//
// What bounds it on the H100: arithmetic. Per (item, hash) it does
// N*d*Rx*Rp fused multiply-adds (432 at the serving shape N=3, d=12, Rx=4,
// Rp=3) on 576 bytes of input that every hash of the item reuses, so the
// fp32 rate outside the tensor cores (67 TFLOP/s) bounds it, not the
// 3.35 TB/s of HBM.
//
// What the design does about it: the input bytes are read from HBM once,
// and the inner loop keeps its operands in registers. A block owns
// block_b items and lb tables (grid = item blocks x table blocks; one thread
// per (item, table), item fastest within a warp). It stages its items'
// factors once, transposed item-fastest (each thread reads its own item,
// neighbouring threads neighbouring banks), and its tables' projections
// (read by a whole warp at one address, a broadcast). Per code and mode a
// thread loads the Rp projection entries of one row d into registers, then
// for each of its Rx factor entries of that row does Rp FMAs into an
// Rx x Rp register tile of the mode's Gram, so a shared-memory load feeds
// Rx*Rp/(Rx+Rp) FMAs (1.7 at Rx=4, Rp=3) instead of a half. The cross-mode
// Hadamard product and the (r, q) sum stay in registers; the ranks are
// compile-time bounded (RMAX) so the tiles live in registers. The per-mode
// Gram could run on the tensor cores in TF32, but that rounds the inputs to
// a 10-bit mantissa and flips codes next to bucket edges; it is left to a
// later change that keeps fp32 accuracy (e.g. 3xTF32).
//
// Rounding: scale * v uses __fmul_rn and the epilogue __fadd_rn /
// __fdiv_rn, so that the compiler cannot contract them into one FMA and
// E2LSH divides by w (IEEE, never a multiply by 1/w), as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int RMAX = 8;  // largest rank (Rx, Rp) the register tiles hold

template <int RT>
__global__ void cp_gram_kernel(const float* __restrict__ x,      // (B, N, D, RX)
                               const float* __restrict__ p,      // (N, L, K, D, RP)
                               const float* __restrict__ offsets,  // (L, K)
                               const long long* __restrict__ mults,  // (K,)
                               void* __restrict__ out, int B, int N, int D,
                               int RX, int L, int K, int RP, int epilogue,
                               float w, float scale, int bb, int lb) {
  extern __shared__ float smem[];
  const int F = N * D * RX;           // floats of one item
  const int PK = D * RP;              // floats of one (mode, hash) factor
  float* xs = smem;                   // [F][bb], item fastest
  float* ps = smem + (size_t)F * bb;  // [lb][K][N][D][RP]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int l0 = blockIdx.y * lb;
  const int nl = min(lb, L - l0);
  const long long z0 = (long long)blockIdx.x * bb;
  const long long left = (long long)B - z0;
  const int nitems = left < bb ? (int)left : bb;

  for (int i = tid; i < nitems * F; i += nthreads) {
    const int zz = i / F;
    const int f = i - zz * F;
    xs[f * bb + zz] = x[z0 * F + i];
  }
  const int per_table = K * N * PK;
  for (int i = tid; i < nl * per_table; i += nthreads) {
    const int li = i / per_table;
    int rem = i - li * per_table;
    const int k = rem / (N * PK);
    rem -= k * N * PK;
    const int n = rem / PK;
    const int e = rem - n * PK;
    ps[i] = p[(((size_t)n * L + l0 + li) * K + k) * PK + e];
  }
  __syncthreads();
  const int zi = tid % bb;
  const int li = tid / bb;
  if (zi >= nitems || li >= nl) return;
  const long long z = z0 + zi;
  const int l = l0 + li;
  const float* pl = ps + (size_t)li * per_table;

  const EpilogueArgs ea{offsets, mults, out, L, K, epilogue, w};
  EpilogueTail tail;
  for (int k = 0; k < K; ++k) {
    const float* pk = pl + (size_t)k * N * PK;
    float acc[RT][RT];
    for (int n = 0; n < N; ++n) {
      float g[RT][RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < RT; ++q) g[r][q] = 0.f;
      const float* xn = xs + (size_t)(n * D) * RX * bb + zi;
      const float* pn = pk + n * PK;
      for (int d = 0; d < D; ++d) {
        float pv[RT];
#pragma unroll
        for (int q = 0; q < RT; ++q) pv[q] = q < RP ? pn[d * RP + q] : 0.f;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < RX) {
            const float xv = xn[(d * RX + r) * bb];
#pragma unroll
            for (int q = 0; q < RT; ++q) g[r][q] += xv * pv[q];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < RT; ++q)
          acc[r][q] = (n == 0) ? g[r][q] : acc[r][q] * g[r][q];
    }
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < RT; ++q)
        if (r < RX && q < RP) v += acc[r][q];
    tail.push(ea, z, l, k, __fmul_rn(scale, v));
  }
  tail.finish(ea, z, l);
}

template <int RT>
int launch(const float* x, const float* p, const float* offsets,
           const long long* mults, void* out, int B, int N, int D, int RX,
           int L, int K, int RP, int epilogue, float w, float scale, int bb,
           int lb, cudaStream_t stream) {
  const size_t smem =
      ((size_t)N * D * RX * bb + (size_t)lb * K * N * D * RP) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cp_gram_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((B + bb - 1) / bb), (unsigned)((L + lb - 1) / lb));
  cp_gram_kernel<RT><<<grid, bb * lb, smem, stream>>>(
      x, p, offsets, mults, out, B, N, D, RX, L, K, RP, epilogue, w, scale,
      bb, lb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cp_gram_launch(const float* x, const float* p,
                              const float* offsets, const long long* mults,
                              void* out, int B, int N, int D, int RX, int L,
                              int K, int RP, int epilogue, float w, float scale,
                              int block_b, int block_l, void* stream) {
  if (RX > RMAX || RP > RMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (RX <= 4 && RP <= 4)
    return launch<4>(x, p, offsets, mults, out, B, N, D, RX, L, K, RP,
                     epilogue, w, scale, block_b, block_l, st);
  return launch<RMAX>(x, p, offsets, mults, out, B, N, D, RX, L, K, RP,
                      epilogue, w, scale, block_b, block_l, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
