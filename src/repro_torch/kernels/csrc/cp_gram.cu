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
// Shapes past one block. A table whose K hashes' factors do not fit the
// staging budget beside the items is tiled over hashes: a third grid
// dimension takes block_k hashes at a time, and the epilogue combines the
// chunks' partial keys and packed words exactly (epilogue.cuh). Ranks above
// 8 (up to 32, benchmarks/kernels.py's R = 32), and shapes of which not
// even one item and one hash fit the staging budget, take a second kernel,
// cp_gram_warp_kernel: one warp per (item, table), looping over the
// table's hashes; lane r holds row r of the running Rx x Rp Hadamard
// product, its Rp Gram entries in registers, and reads its item's column r
// (a coalesced load) and the hash's rows (one address per warp, a
// broadcast) through the read-only cache, staging nothing; a shuffle
// reduction sums the rows.
//
// Rounding: scale * v uses __fmul_rn and the epilogue __fadd_rn /
// __fdiv_rn, so that the compiler cannot contract them into one FMA and
// E2LSH divides by w (IEEE, never a multiply by 1/w), as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int RMAX = 8;    // largest rank (Rx, Rp) the register tiles hold
constexpr int RWARP = 32;  // largest rank of the warp kernel

template <int RT>
__global__ void cp_gram_kernel(const float* __restrict__ x,      // (B, N, D, RX)
                               const float* __restrict__ p,      // (N, L, K, D, RP)
                               const float* __restrict__ offsets,  // (L, K)
                               const long long* __restrict__ mults,  // (K,)
                               void* __restrict__ out, int B, int N, int D,
                               int RX, int L, int K, int RP, int epilogue,
                               float w, float scale, int bb, int lb, int kb) {
  extern __shared__ float smem[];
  const int F = N * D * RX;           // floats of one item
  const int PK = D * RP;              // floats of one (mode, hash) factor
  float* xs = smem;                   // [F][bb], item fastest
  float* ps = smem + (size_t)F * bb;  // [lb][kn][N][D][RP]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int l0 = blockIdx.y * lb;
  const int nl = min(lb, L - l0);
  const int k0 = blockIdx.z * kb;     // this block's hashes [k0, k0 + kn)
  const int kn = min(kb, K - k0);
  const long long z0 = (long long)blockIdx.x * bb;
  const long long left = (long long)B - z0;
  const int nitems = left < bb ? (int)left : bb;

  for (int i = tid; i < nitems * F; i += nthreads) {
    const int zz = i / F;
    const int f = i - zz * F;
    xs[f * bb + zz] = x[z0 * F + i];
  }
  const int per_table = kn * N * PK;
  for (int i = tid; i < nl * per_table; i += nthreads) {
    const int li = i / per_table;
    int rem = i - li * per_table;
    const int k = rem / (N * PK);
    rem -= k * N * PK;
    const int n = rem / PK;
    const int e = rem - n * PK;
    ps[i] = p[(((size_t)n * L + l0 + li) * K + k0 + k) * PK + e];
  }
  __syncthreads();
  const int zi = tid % bb;
  const int li = tid / bb;
  if (zi >= nitems || li >= nl) return;
  const long long z = z0 + zi;
  const int l = l0 + li;
  const float* pl = ps + (size_t)li * per_table;

  const EpilogueArgs ea{offsets, mults, out, L, K, epilogue, w, k0 + kn,
                        (int)(gridDim.z > 1)};
  EpilogueTail tail;
  for (int k = 0; k < kn; ++k) {
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
    tail.push(ea, z, l, k0 + k, __fmul_rn(scale, v));
  }
  tail.finish(ea, z, l);
}

// Ranks above RMAX: one warp per (item, table) over the table's K hashes,
// lane r < RX owning row r of the Hadamard product (RW = RWARP registers
// of Gram entries and RW of the running product).
template <int RW>
__global__ void __launch_bounds__(256)
cp_gram_warp_kernel(const float* __restrict__ x,        // (B, N, D, RX)
                    const float* __restrict__ p,        // (N, L, K, D, RP)
                    const float* __restrict__ offsets,  // (L, K)
                    const long long* __restrict__ mults,  // (K,)
                    void* __restrict__ out, int B, int N, int D, int RX,
                    int L, int K, int RP, int epilogue, float w,
                    float scale) {
  const long long pair =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= (long long)B * L) return;  // whole warps leave together
  const long long z = pair / L;
  const int l = (int)(pair - z * L);
  const bool row = lane < RX;
  const float* xz = x + (size_t)z * N * D * RX + lane;
  const EpilogueArgs ea{offsets, mults, out, L, K, epilogue, w};
  EpilogueTail tail;
  for (int k = 0; k < K; ++k) {
    float acc[RW];
    for (int n = 0; n < N; ++n) {
      float g[RW];
#pragma unroll
      for (int q = 0; q < RW; ++q) g[q] = 0.f;
      const float* xn = xz + (size_t)n * D * RX;
      const float* pn = p + (((size_t)n * L + l) * K + k) * D * RP;
      for (int d = 0; d < D; ++d) {
        const float xv = row ? __ldg(xn + d * RX) : 0.f;
#pragma unroll
        for (int q = 0; q < RW; ++q)
          if (q < RP) g[q] += xv * __ldg(pn + d * RP + q);
      }
#pragma unroll
      for (int q = 0; q < RW; ++q) acc[q] = (n == 0) ? g[q] : acc[q] * g[q];
    }
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < RW; ++q)
      if (q < RP) v += acc[q];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) tail.push(ea, z, l, k, __fmul_rn(scale, v));
  }
  if (lane == 0) tail.finish(ea, z, l);
}

template <int RT>
int launch(const float* x, const float* p, const float* offsets,
           const long long* mults, void* out, int B, int N, int D, int RX,
           int L, int K, int RP, int epilogue, float w, float scale, int bb,
           int lb, int kb, cudaStream_t stream) {
  const size_t smem =
      ((size_t)N * D * RX * bb + (size_t)lb * kb * N * D * RP) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cp_gram_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((B + bb - 1) / bb), (unsigned)((L + lb - 1) / lb),
            (unsigned)((K + kb - 1) / kb));
  cp_gram_kernel<RT><<<grid, bb * lb, smem, stream>>>(
      x, p, offsets, mults, out, B, N, D, RX, L, K, RP, epilogue, w, scale,
      bb, lb, kb);
  return (int)cudaGetLastError();
}

}  // namespace

// block_k < K tiles each table's hashes over blocks (only with block_l = 1);
// the wrapper then hands in a zeroed output for the *-keys and srp-packed
// epilogues. Ranks above RMAX, or block_b = 0 (a shape of which one item
// and one hash do not fit the staging budget), run the warp kernel.
extern "C" int cp_gram_launch(const float* x, const float* p,
                              const float* offsets, const long long* mults,
                              void* out, int B, int N, int D, int RX, int L,
                              int K, int RP, int epilogue, float w, float scale,
                              int block_b, int block_l, int block_k,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (RX > RWARP || RP > RWARP) return (int)cudaErrorInvalidValue;
  if (RX > RMAX || RP > RMAX || block_b == 0) {
    const long long threads = (long long)B * L * 32;
    cp_gram_warp_kernel<RWARP><<<(unsigned)((threads + 255) / 256), 256, 0,
                                 st>>>(x, p, offsets, mults, out, B, N, D,
                                       RX, L, K, RP, epilogue, w, scale);
    return (int)cudaGetLastError();
  }
  if (block_k < K && block_l != 1) return (int)cudaErrorInvalidValue;
  if (RX <= 4 && RP <= 4)
    return launch<4>(x, p, offsets, mults, out, B, N, D, RX, L, K, RP,
                     epilogue, w, scale, block_b, block_l, block_k, st);
  return launch<RMAX>(x, p, offsets, mults, out, B, N, D, RX, L, K, RP,
                      epilogue, w, scale, block_b, block_l, block_k, st);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
