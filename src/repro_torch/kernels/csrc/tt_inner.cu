// K4: batch-native fused TT x TT hashing (the transfer-matrix chain) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/tt_inner.py::_tt_hash_kernel (the
// pl.pallas_call in tt_inner_pallas) together with its fused
// repro/kernels/epilogues.py::apply_epilogue tail. For a batch of TT inputs
// X_z (cores Gx, boundary ranks zero-padded to Rx) and the L*K stacked TT
// projections T_{l,k} (cores Gp, padded to Rp) it computes
//
//     S <- e_00;  S <- sum_i Gx[:, i, :]^T S Gp[:, i, :]  for each mode;
//     v[z, l, k] = scale * S[0, 0]
//
// (S is Rx x Rp per (item, hash) pair) and applies the epilogue
// (csrc/epilogue.cuh, shared with K3), so only the epilogue's output is
// stored: raw values, E2LSH codes, SRP bits, uint32 radix keys or packed
// SRP bits.
//
// What bounds it on the H100: arithmetic. Per (item, hash) and interior
// mode it does d*(Rx*Rp*Rp + Rx*Rx*Rp) fused multiply-adds (2048 at d=16,
// R=4), against 2 KiB of cores that every hash of the item, or every item
// of the hash, reuses; at the cell's true ranks (1, 4, 4, 4, 1) that is
// 4736 FMA, 9.4 kFLOP, per pair, so the fp32 rate outside the tensor cores
// (67 TFLOP/s) bounds it, far above the bytes' time at 3.35 TB/s.
//
// What the design does about it (a first, simple form): one thread per
// (item, hash) pair holds its state S in registers, the ranks bounded at
// compile time (RT = 4 or 8; the wrapper raises above 8). A block owns bb
// items and lb whole tables (lb*K hashes), item fastest within a warp, and
// walks the modes in order: per mode it stages its items' cores (item
// fastest, so each thread reads its own item from its own bank) and its
// hashes' cores (read by a whole warp at one address, a broadcast) into
// shared memory, then every pair applies S <- sum_i Gx_i^T (S Gp_i), the
// product S Gp_i in registers first. Mode 0 skips the padded rows (S = e_00
// selects row 0 of both cores) and the last mode forms only S[0, 0], which
// is what the padded chain computes. Staging one mode at a time keeps a
// block's shared memory at (bb + lb*K) cores. The scaled values go through
// shared memory to one thread per (item, table), which runs the epilogue.
// The items' cores are staged once per table block, so a launch moves them
// from L2 ceil(L/lb) times; wgmma (3xTF32), TMA and several pairs per
// thread are later changes.
//
// Shapes past one block. A table of more than MAX_THREADS hashes (K up to
// benchmarks/collision.py's 2000) is tiled over hashes: a third grid
// dimension takes block_k hashes at a time (one table, block_l = 1), and
// the epilogue combines the chunks' partial keys and packed words exactly
// (epilogue.cuh). Ranks above 8 (up to 16, benchmarks/kernels.py's R = 16),
// and cores too large to stage, take a second kernel, tt_inner_warp_kernel: a 16 x 16 state would take
// 256 of a thread's 255 registers, so one warp steps one (item, hash)
// chain at a time, over the hashes of its (item, table): the state S and
// the product T = S Gp_i sit in the warp's shared memory, each lane owns
// entries (c, e) of S' and accumulates
//   T[a][e] = sum_b S[a][b] Gp[b][i][e],  S'[c][e] += sum_a Gx[a][i][c] T[a][e]
// per slice i (Rx*Rp*(Rp + Rx) FMA, the chain's own count), reading the
// cores through the read-only cache; lane 0 runs the epilogue.
//
// Rounding: inside the chain FMA contraction is allowed (raw values are held
// to a rounding bound, repro_torch/kernels/parity.py::tt_raw_bound); scale *
// v uses __fmul_rn, and the epilogue __fadd_rn / __fdiv_rn.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int RMAX = 8;       // largest rank (Rx, Rp) the register tiles hold
constexpr int RWARP = 16;     // largest rank of the warp kernel
constexpr int MAX_THREADS = 512;
constexpr int WARP_BLOCK = 8;  // warps of a warp-kernel block

template <int RT>
__global__ void __launch_bounds__(MAX_THREADS)
tt_inner_kernel(const float* __restrict__ x,        // (B, N, RX, D, RX)
                const float* __restrict__ p,        // (N, L, K, RP, D, RP)
                const float* __restrict__ offsets,  // (L, K)
                const long long* __restrict__ mults,  // (K,)
                void* __restrict__ out, int B, int N, int D, int RX, int L,
                int K, int RP, int epilogue, float w, float scale, int bb,
                int lb, int kb) {
  extern __shared__ float smem[];
  const int FX = RX * D * RX;          // floats of one item's mode core
  const int FP = RP * D * RP;          // floats of one hash's mode core
  const int l0 = blockIdx.y * lb;
  const int nl = min(lb, L - l0);
  const int k0 = blockIdx.z * kb;      // this block's hashes [k0, k0 + kn)
  const int kn = min(kb, K - k0);      // of each of its tables
  const int H = nl * kn;               // hashes of this block
  const long long z0 = (long long)blockIdx.x * bb;
  const long long left = (long long)B - z0;
  const int nitems = left < bb ? (int)left : bb;
  float* xs = smem;                    // [FX][bb], item fastest
  float* ps = smem + (size_t)FX * bb;  // [H][FP]
  const int tid = threadIdx.x;
  const int zi = tid % bb;
  const int h = tid / bb;
  const bool active = zi < nitems && h < H;
  const float* xz = xs + zi;           // x[a][i][c] at xz[((a*D+i)*RX+c)*bb]
  const float* ph = ps + (size_t)h * FP;  // p[b][i][e] at ph[(b*D+i)*RP+e]

  float s[RT][RT];
  float v = 0.f;
  for (int n = 0; n < N; ++n) {
    __syncthreads();  // every thread is done with the previous mode's cores
    for (int i = tid; i < nitems * FX; i += blockDim.x) {
      const int zz = i / FX;
      const int f = i - zz * FX;
      xs[f * bb + zz] = x[((z0 + zz) * N + n) * FX + f];
    }
    // the block's hashes are contiguous: whole tables, or one table's chunk
    const float* pn = p + (((size_t)n * L + l0) * K + k0) * FP;
    for (int i = tid; i < H * FP; i += blockDim.x) ps[i] = pn[i];
    __syncthreads();
    if (!active) continue;
    if (n == 0) {
      // S = e_00: S'[c][e] = sum_i Gx[0][i][c] Gp[0][i][e]
#pragma unroll
      for (int c = 0; c < RT; ++c)
#pragma unroll
        for (int e = 0; e < RT; ++e) s[c][e] = 0.f;
      for (int i = 0; i < D; ++i) {
        float pv[RT];
#pragma unroll
        for (int e = 0; e < RT; ++e) pv[e] = e < RP ? ph[i * RP + e] : 0.f;
#pragma unroll
        for (int c = 0; c < RT; ++c) {
          if (c < RX) {
            const float xv = xz[(i * RX + c) * bb];
#pragma unroll
            for (int e = 0; e < RT; ++e) s[c][e] += xv * pv[e];
          }
        }
      }
      if (N == 1) v = s[0][0];
    } else if (n == N - 1) {
      // only S'[0][0] = sum_i sum_a Gx[a][i][0] sum_b S[a][b] Gp[b][i][0]
      float acc = 0.f;
      for (int i = 0; i < D; ++i) {
        float pv[RT];
#pragma unroll
        for (int b = 0; b < RT; ++b)
          pv[b] = b < RP ? ph[(b * D + i) * RP] : 0.f;
#pragma unroll
        for (int a = 0; a < RT; ++a) {
          if (a < RX) {
            float t = 0.f;
#pragma unroll
            for (int b = 0; b < RT; ++b) t += s[a][b] * pv[b];
            acc += xz[((a * D + i) * RX) * bb] * t;
          }
        }
      }
      v = acc;
    } else {
      float sn[RT][RT];
#pragma unroll
      for (int c = 0; c < RT; ++c)
#pragma unroll
        for (int e = 0; e < RT; ++e) sn[c][e] = 0.f;
      for (int i = 0; i < D; ++i) {
        float pv[RT][RT];
#pragma unroll
        for (int b = 0; b < RT; ++b)
#pragma unroll
          for (int e = 0; e < RT; ++e)
            pv[b][e] = (b < RP && e < RP) ? ph[(b * D + i) * RP + e] : 0.f;
#pragma unroll
        for (int a = 0; a < RT; ++a) {
          if (a < RX) {
            float t[RT];  // (S Gp_i)[a][:]
#pragma unroll
            for (int e = 0; e < RT; ++e) {
              t[e] = 0.f;
#pragma unroll
              for (int b = 0; b < RT; ++b) t[e] += s[a][b] * pv[b][e];
            }
#pragma unroll
            for (int c = 0; c < RT; ++c) {
              if (c < RX) {
                const float xv = xz[((a * D + i) * RX + c) * bb];
#pragma unroll
                for (int e = 0; e < RT; ++e) sn[c][e] += xv * t[e];
              }
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < RT; ++c)
#pragma unroll
        for (int e = 0; e < RT; ++e) s[c][e] = sn[c][e];
    }
  }

  // epilogue: the scaled values through shared memory, then one thread per
  // (item, table) feeds its K values to the shared tail
  __syncthreads();
  float* vs = smem;  // [bb][H]
  if (active) vs[zi * H + h] = __fmul_rn(scale, v);
  __syncthreads();
  const EpilogueArgs ea{offsets, mults, out, L, K, epilogue, w, k0 + kn,
                        (int)(gridDim.z > 1)};
  for (int t = tid; t < bb * nl; t += blockDim.x) {
    const int zz = t % bb;
    const int lt = t / bb;
    if (zz >= nitems) continue;
    EpilogueTail tail;
    for (int k = 0; k < kn; ++k)
      tail.push(ea, z0 + zz, l0 + lt, k0 + k, vs[zz * H + lt * kn + k]);
    tail.finish(ea, z0 + zz, l0 + lt);
  }
}

// Ranks above RMAX: one warp per (item, table) steps its hashes' chains one
// after another, the state in the warp's shared memory (see the header).
template <int RW>
__global__ void __launch_bounds__(WARP_BLOCK * 32)
tt_inner_warp_kernel(const float* __restrict__ x,        // (B, N, RX, D, RX)
                     const float* __restrict__ p,        // (N, L, K, RP, D, RP)
                     const float* __restrict__ offsets,  // (L, K)
                     const long long* __restrict__ mults,  // (K,)
                     void* __restrict__ out, int B, int N, int D, int RX,
                     int L, int K, int RP, int epilogue, float w,
                     float scale) {
  constexpr int PER = RW * RW / 32;    // state entries a lane owns
  __shared__ float st[WARP_BLOCK][2][RW * RW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * WARP_BLOCK + warp;
  if (pair >= (long long)B * L) return;  // whole warps leave together
  const long long z = pair / L;
  const int l = (int)(pair - z * L);
  float* S = st[warp][0];              // [RX][RP]
  float* T = st[warp][1];              // [RX][RP], S Gp_i
  const int NE = RX * RP;
  const int FX = RX * D * RX, FP = RP * D * RP;
  const EpilogueArgs ea{offsets, mults, out, L, K, epilogue, w};
  EpilogueTail tail;
  for (int k = 0; k < K; ++k) {
    for (int q = lane; q < NE; q += 32) S[q] = q == 0 ? 1.f : 0.f;
    __syncwarp();
    for (int n = 0; n < N; ++n) {
      const float* gx = x + ((size_t)z * N + n) * FX;               // [a][i][c]
      const float* gp = p + (((size_t)n * L + l) * K + k) * FP;     // [b][i][e]
      float acc[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) acc[j] = 0.f;
      for (int i = 0; i < D; ++i) {
        for (int q = lane; q < NE; q += 32) {
          const int a = q / RP, e = q - a * RP;
          float t = 0.f;
          for (int b = 0; b < RP; ++b)
            t += S[a * RP + b] * __ldg(gp + (b * D + i) * RP + e);
          T[q] = t;
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int q = lane + 32 * j;
          if (q < NE) {
            const int c = q / RP, e = q - c * RP;
            float u = 0.f;
            for (int a = 0; a < RX; ++a)
              u += __ldg(gx + (a * D + i) * RX + c) * T[a * RP + e];
            acc[j] += u;
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int j = 0; j < PER; ++j)
        if (lane + 32 * j < NE) S[lane + 32 * j] = acc[j];
      __syncwarp();
    }
    const float v = S[0];
    __syncwarp();  // every lane has read S before the next chain resets it
    if (lane == 0) tail.push(ea, z, l, k, __fmul_rn(scale, v));
  }
  if (lane == 0) tail.finish(ea, z, l);
}

template <int RT>
int launch(const float* x, const float* p, const float* offsets,
           const long long* mults, void* out, int B, int N, int D, int RX,
           int L, int K, int RP, int epilogue, float w, float scale, int bb,
           int lb, int kb, cudaStream_t stream) {
  const int threads = bb * lb * kb;
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidConfiguration;
  const size_t stage =
      (size_t)RX * D * RX * bb + (size_t)lb * kb * RP * D * RP;
  const size_t vals = (size_t)bb * lb * kb;
  const size_t smem = (stage > vals ? stage : vals) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tt_inner_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((B + bb - 1) / bb), (unsigned)((L + lb - 1) / lb),
            (unsigned)((K + kb - 1) / kb));
  tt_inner_kernel<RT><<<grid, threads, smem, stream>>>(
      x, p, offsets, mults, out, B, N, D, RX, L, K, RP, epilogue, w, scale,
      bb, lb, kb);
  return (int)cudaGetLastError();
}

}  // namespace

// block_k < K tiles the table's hashes over blocks (only with block_l = 1);
// the wrapper then hands in a zeroed output for the *-keys and srp-packed
// epilogues. Ranks above RMAX (up to RWARP), or block_b = 0 (cores that do
// not fit the staging budget), run the warp kernel.
extern "C" int tt_inner_launch(const float* x, const float* p,
                               const float* offsets, const long long* mults,
                               void* out, int B, int N, int D, int RX, int L,
                               int K, int RP, int epilogue, float w,
                               float scale, int block_b, int block_l,
                               int block_k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (RX > RWARP || RP > RWARP) return (int)cudaErrorInvalidValue;
  if (RX > RMAX || RP > RMAX || block_b == 0) {
    const long long pairs = (long long)B * L;
    tt_inner_warp_kernel<RWARP>
        <<<(unsigned)((pairs + WARP_BLOCK - 1) / WARP_BLOCK), WARP_BLOCK * 32,
           0, st>>>(x, p, offsets, mults, out, B, N, D, RX, L, K, RP,
                    epilogue, w, scale);
    return (int)cudaGetLastError();
  }
  if (block_k < K && block_l != 1) return (int)cudaErrorInvalidValue;
  if (RX <= 4 && RP <= 4)
    return launch<4>(x, p, offsets, mults, out, B, N, D, RX, L, K, RP,
                     epilogue, w, scale, block_b, block_l, block_k, st);
  return launch<RMAX>(x, p, offsets, mults, out, B, N, D, RX, L, K, RP,
                      epilogue, w, scale, block_b, block_l, block_k, st);
}
