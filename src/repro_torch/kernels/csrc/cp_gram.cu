// K3: batch-native fused CP x CP hashing for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cp_gram.py::_cp_hash_kernel (the
// pl.pallas_call in cp_gram_pallas) together with its fused
// repro/kernels/epilogues.py::apply_epilogue tail. For a batch of CP inputs
// X_z and the L*K stacked CP projections P_{l,k} it computes
//
//     v[z, l, k] = scale * sum_{r,q} prod_n (X_{z,n}^T P_{(l,k),n})[r, q]
//
// and applies the epilogue (csrc/epilogue.cuh, shared with K4), so only the
// epilogue's output is stored: raw values, E2LSH codes, SRP bits, uint32
// radix keys or packed SRP bits.
//
// What bounds it on the H100: arithmetic. Per (item, hash) it does
// N*d*Rx*Rp fused multiply-adds (432 at the serving shape N=3, d=12, Rx=4,
// Rp=3) on 576 bytes of input that every hash of the item reuses, so the
// fp32 rate outside the tensor cores (67 TFLOP/s) bounds it, not the
// 3.35 TB/s of HBM.
//
// The thread kernel (ranks up to 8), cp_gram_kernel<RXT, RPT>. The first
// form gave a thread one (item, table) and its K hashes in turn, in blocks
// of 64 items x 10 tables: a 1,024-item launch was 16 blocks on 132 SMs,
// and a build launch held one 640-thread block a SM. Now:
//  - a block is (block items) x (block hashes) picked by the planner
//    (cp_gram.py::plan) from the launch's shape and the card's SM count,
//    at least two blocks a SM wherever the pairs allow; the grid walks the
//    hash blocks of one item block together (hash block fastest);
//  - each thread holds a register tile of TI items x TH hashes (2 x 2 at
//    ranks up to 4, 1 x 1 up to 8): per mode row d a staged factor row of
//    an item feeds TH Grams and one of a hash TI. A warp is 8 item lanes x
//    4 hash lanes, each row one or two float4 shared loads without bank
//    conflicts (epilogue.cuh's layout);
//  - the ranks are compile-time: <4, 3> at the serving shape (no FMA
//    multiplies padding, where the first form's 4 x 4 tile spent a quarter
//    of its Gram FMAs on zeros), <4, 4> and <8, 8> pad other ranks with
//    zero rows and columns (exact zeros in every Gram);
//  - the block stages its items' factors and its hashes' rows once with
//    cp.async (16 bytes a copy where a row is whole float4s);
//  - the scaled values go through shared memory to the block epilogue,
//    which combines a table split over hash blocks exactly.
// Per (item, hash) the Gram entries accumulate over d by FMA in the first
// form's order, the modes multiply with __fmul_rn and the (r, q) sum runs
// r-major, so raw values and keys are bit-equal to the first form's. What
// bounds it now: a block stages once and then computes, so the wait for
// its rows (about 40% of a block's cycles on the H100) is hidden only by
// the other resident blocks, and the Gram runs at about a quarter of the
// fp32 peak. The per-mode Gram could run on the tensor cores in TF32, but
// that rounds the inputs to a 10-bit mantissa and flips codes next to
// bucket edges.
//
// The warp kernel (ranks 9-32, benchmarks/kernels.py's R = 32, and shapes
// of which the thread kernel cannot stage one item and one hash),
// cp_gram_warp_kernel: one warp per (item, hash), a block of WB warps
// holding one item and WB hashes (the planner's WB). Lane r owns row r of
// the Rx x Rp Gram and of the running Hadamard product in registers, reads
// its item's column r (a coalesced load a row d) and its hash's row d from
// the warp's shared copy (float4 broadcasts; the rows are staged in chunks
// with cp.async); a shuffle reduction sums the rows, in the first form's
// order. The first form ran one warp per (item, table) over its K hashes
// in turn and read every projection entry by __ldg inside the FMA loop.
// What bounds it now: one shared float4 load a lane feeds 4 FMA, and each
// chunk of rows is waited for before it is used; it runs at about a fifth
// of the fp32 peak at R = 32.
//
// Rounding: scale * v uses __fmul_rn and the epilogue __fadd_rn /
// __fdiv_rn, so that the compiler cannot contract them into one FMA and
// E2LSH divides by w (IEEE, never a multiply by 1/w), as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int RMAX = 8;          // largest rank (Rx, Rp) of the thread kernel
constexpr int RWARP = 32;        // largest rank of the warp kernel
constexpr int kThreadMax = 128;  // threads of a thread-kernel block, at most
constexpr int kWarpBlockMax = 8;  // warps of a warp-kernel block, at most
constexpr int kWarpChunk = 2048;  // floats of a warp's staged projection rows

template <int RXT, int RPT>
struct Tile {  // the register tile of cp_gram_kernel<RXT, RPT>
  static constexpr int TI = RXT <= 4 ? 2 : 1, TH = RXT <= 4 ? 2 : 1;
};

// Shared bytes of a thread-kernel block: every mode row of its items
// (QX float4 units a row, slot stride bi + 1) and of its hashes (QP units,
// stride bh + 1), or the block's scaled values, whichever is larger.
size_t thread_smem(int N, int D, int QX, int QP, int bi, int bh) {
  const size_t rows = (size_t)N * D;
  return max_bytes(rows * (QX * (bi + 1) + QP * (bh + 1)) * sizeof(float4),
                   (size_t)bi * bh * sizeof(float));
}

// Shared bytes of a warp-kernel block of wb warps: each warp's chunk of
// projection rows, and the block's values.
size_t warp_smem(int wb) {
  return ((size_t)wb * kWarpChunk + wb) * sizeof(float);
}

// Copies rows [0, nrows) of entities [0, nvalid) into units from row0 on:
// entity e's row r is ract floats at g + e * estride + r * ract, padded
// with zeros to RS floats (RS / 4 float4 units a row); unit u of entity e
// sits in slot u * NS + e, the slot stride NS = NE + 1 odd (NE entities,
// an even count), so eight lanes reading one unit of 8 consecutive
// entities, and eight lanes writing 8 consecutive units of one entity,
// touch 8 distinct 16-byte bank groups. vec: ract == RS and every row
// 16-byte aligned. Entities past nvalid keep stale slots (their threads
// store nothing). Issues cp.async copies; the caller commits, waits and
// synchronises.
template <int RS>
__device__ __forceinline__ void stage_rows(float4* s4, int NS, int row0,
                                           const float* g, long long estride,
                                           int nrows, int ract, int nvalid,
                                           bool vec) {
  constexpr int Q = RS / 4;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int per = nrows * Q;  // units of one entity
  for (int j = tid; j < nvalid * per; j += nthreads) {
    const int e = j / per, u = j - e * per;
    float4* dst = s4 + (size_t)(row0 * Q + u) * NS + e;
    if (vec) {
      cp_async16(dst, g + e * estride + 4 * u);
    } else {
      const int r = u / Q, c0 = 4 * (u - r * Q);
      const float* src = g + e * estride + (long long)r * ract + c0;
      float* d = reinterpret_cast<float*>(dst);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c0 + c < ract)
          cp_async4(d + c, src + c);
        else
          d[c] = 0.f;
      }
    }
  }
}

template <int RXT, int RPT>
__global__ void __launch_bounds__(kThreadMax)
cp_gram_kernel(const float* __restrict__ x,  // (B, N, D, RX)
               const float* __restrict__ p,  // (N, L*K, D, RP)
               EpilogueArgs ea, int B, int N, int D, int RX, int RP,
               float scale, int BI, int BH, int nhb, int vecx, int vecp) {
  constexpr int TI = Tile<RXT, RPT>::TI, TH = Tile<RXT, RPT>::TH;
  constexpr int QX = (RXT + 3) / 4, QP = (RPT + 3) / 4;
  extern __shared__ float4 smem4[];
  const int LK = ea.L * ea.K;
  const int hb = blockIdx.x % nhb;  // hash blocks of one item block together
  const long long z0 = (long long)(blockIdx.x / nhb) * BI;
  const int h0 = hb * BH, nh = min(BH, LK - h0);
  const int nz = (int)min((long long)BI, (long long)B - z0);
  const int NSX = BI + 1, NSP = BH + 1;
  float4* xs = smem4;                                // unit (n*D+d)*QX + q
  float4* ps = smem4 + (size_t)N * D * QX * NSX;     // unit (n*D+d)*QP + q

  stage_rows<4 * QX>(xs, NSX, 0, x + z0 * N * D * RX, (long long)N * D * RX,
                     N * D, RX, nz, vecx);
  for (int n = 0; n < N; ++n)
    stage_rows<4 * QP>(ps, NSP, n * D, p + ((size_t)n * LK + h0) * D * RP,
                       (long long)D * RP, D, RP, nh, vecp);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = BI / (kItemLanes * TI);
  const int zi = (warp % wn) * kItemLanes * TI + (lane & 7);  // + 8 t
  const int hi = (warp / wn) * kHashLanes * TH + (lane >> 3);  // + 4 u
  const bool active = zi < nz && hi < nh;
  float v[TI][TH];
  if (active) {
    const float4* xb = xs + zi;  // unit u of item zi + 8t: xb[u*NSX + 8t]
    const float4* pb = ps + hi;  // unit u of hash hi + 4u: pb[u*NSP + 4u]
    float acc[TI][TH][RXT][RPT];
    for (int n = 0; n < N; ++n) {
      float g[TI][TH][RXT][RPT];
#pragma unroll
      for (int t = 0; t < TI; ++t)
#pragma unroll
        for (int u = 0; u < TH; ++u)
#pragma unroll
          for (int r = 0; r < RXT; ++r)
#pragma unroll
            for (int q = 0; q < RPT; ++q) g[t][u][r][q] = 0.f;
      for (int d = 0; d < D; ++d) {
        const int row = n * D + d;
        float4 xr[TI][QX], pr[TH][QP];
#pragma unroll
        for (int c = 0; c < QX; ++c)
#pragma unroll
          for (int t = 0; t < TI; ++t)
            xr[t][c] = xb[(size_t)(row * QX + c) * NSX + 8 * t];
#pragma unroll
        for (int c = 0; c < QP; ++c)
#pragma unroll
          for (int u = 0; u < TH; ++u)
            pr[u][c] = pb[(size_t)(row * QP + c) * NSP + 4 * u];
#pragma unroll
        for (int t = 0; t < TI; ++t)
#pragma unroll
          for (int u = 0; u < TH; ++u)
#pragma unroll
            for (int r = 0; r < RXT; ++r) {
              const float xv = comp(xr[t], r);
#pragma unroll
              for (int q = 0; q < RPT; ++q)
                g[t][u][r][q] = fmaf(xv, comp(pr[u], q), g[t][u][r][q]);
            }
      }
#pragma unroll
      for (int t = 0; t < TI; ++t)
#pragma unroll
        for (int u = 0; u < TH; ++u)
#pragma unroll
          for (int r = 0; r < RXT; ++r)
#pragma unroll
            for (int q = 0; q < RPT; ++q)
              acc[t][u][r][q] = n == 0 ? g[t][u][r][q]
                                       : __fmul_rn(acc[t][u][r][q],
                                                   g[t][u][r][q]);
    }
#pragma unroll
    for (int t = 0; t < TI; ++t)
#pragma unroll
      for (int u = 0; u < TH; ++u) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < RXT; ++r)
#pragma unroll
          for (int q = 0; q < RPT; ++q) s += acc[t][u][r][q];
        v[t][u] = s;
      }
  }
  __syncthreads();  // every thread is done with the staged rows

  // epilogue: the scaled values through shared memory
  float* vs = reinterpret_cast<float*>(smem4);  // [BI][BH]
  if (active) {
#pragma unroll
    for (int t = 0; t < TI; ++t)
#pragma unroll
      for (int u = 0; u < TH; ++u)
        if (zi + 8 * t < nz && hi + 4 * u < nh)
          vs[(zi + 8 * t) * BH + hi + 4 * u] = __fmul_rn(scale, v[t][u]);
  }
  __syncthreads();
  block_epilogue(ea, vs, BH, z0, nz, h0, h0 + nh);
}

// Ranks above RMAX (and shapes the thread kernel cannot stage): one warp
// per (item, hash), lane r owning row r of the Gram (see the header).
__global__ void __launch_bounds__(kWarpBlockMax * 32)
cp_gram_warp_kernel(const float* __restrict__ x,  // (B, N, D, RX)
                    const float* __restrict__ p,  // (N, L*K, D, RP)
                    EpilogueArgs ea, int B, int N, int D, int RX, int RP,
                    float scale, int WB, int nhb, int vecp) {
  constexpr int RW = RWARP;
  extern __shared__ float4 smem4[];
  const int LK = ea.L * ea.K;
  const int hb = blockIdx.x % nhb;
  const long long z = blockIdx.x / nhb;
  const int h0 = hb * WB, nh = min(WB, LK - h0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = reinterpret_cast<float*>(smem4) + warp * kWarpChunk;
  float* vs = reinterpret_cast<float*>(smem4) + WB * kWarpChunk;
  const int RPS = (RP + 3) & ~3;       // a staged row's floats
  const int rows = kWarpChunk / RPS;   // rows of a chunk
  float v = 0.f;
  if (warp < nh) {
    const int h = h0 + warp;
    const bool row = lane < RX;
    const float* xz = x + (size_t)z * N * D * RX + lane;
    float acc[RW];
    for (int n = 0; n < N; ++n) {
      float g[RW];
#pragma unroll
      for (int q = 0; q < RW; ++q) g[q] = 0.f;
      const float* pn = p + ((size_t)n * LK + h) * D * RP;
      for (int d0 = 0; d0 < D; d0 += rows) {
        const int nd = min(rows, D - d0);
        __syncwarp();  // every lane is done with the previous chunk
        if (vecp) {
          for (int j = lane; j < nd * RPS / 4; j += 32)
            cp_async16(buf + 4 * j, pn + (size_t)d0 * RP + 4 * j);
        } else {
          for (int j = lane; j < nd * RPS; j += 32) {
            const int r = j / RPS, c = j - r * RPS;
            if (c < RP)
              cp_async4(buf + j, pn + (size_t)(d0 + r) * RP + c);
            else
              buf[j] = 0.f;
          }
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncwarp();
        for (int dd = 0; dd < nd; ++dd) {
          const float xv =
              row ? __ldg(xz + (size_t)(n * D + d0 + dd) * RX) : 0.f;
          const float4* pr = reinterpret_cast<const float4*>(buf + dd * RPS);
#pragma unroll
          for (int q4 = 0; q4 < RW / 4; ++q4) {
            if (4 * q4 < RP) {
              const float4 pv = pr[q4];
              g[4 * q4] = fmaf(xv, pv.x, g[4 * q4]);
              g[4 * q4 + 1] = fmaf(xv, pv.y, g[4 * q4 + 1]);
              g[4 * q4 + 2] = fmaf(xv, pv.z, g[4 * q4 + 2]);
              g[4 * q4 + 3] = fmaf(xv, pv.w, g[4 * q4 + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RW; ++q)
        acc[q] = n == 0 ? g[q] : __fmul_rn(acc[q], g[q]);
    }
#pragma unroll
    for (int q = 0; q < RW; ++q)
      if (q < RP) v += acc[q];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) vs[warp] = __fmul_rn(scale, v);
  }
  __syncthreads();
  block_epilogue(ea, vs, WB, z, 1, h0, h0 + nh);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The thread kernel's instantiation for these ranks: 43 (<4, 3>, the
// serving shape), 44 (<4, 4>), 88 (<8, 8>), or 0 (the warp kernel).
int inst_of(int RX, int RP) {
  if (RX == 4 && RP == 3) return 43;
  if (RX <= 4 && RP <= 4) return 44;
  if (RX <= RMAX && RP <= RMAX) return 88;
  return 0;
}

// Threads and shared bytes of a plan (block_items 0: the warp kernel with
// block_hashes warps), or threads 0 if the plan is not one of the kernel's.
void plan_shape(int N, int D, int RX, int RP, int bi, int bh, int* threads,
                size_t* smem) {
  *threads = 0;
  *smem = 0;
  if (bi == 0) {
    if (bh >= 1 && bh <= kWarpBlockMax) {
      *threads = 32 * bh;
      *smem = warp_smem(bh);
    }
    return;
  }
  const int inst = inst_of(RX, RP);
  if (inst == 0) return;
  const int tile = inst == 88 ? 1 : 2;
  const int t = tile_threads(bi, bh, tile, tile);
  if (t == 0 || t > kThreadMax) return;
  const int q = inst == 88 ? 2 : 1;  // float4 units of a row, both sides
  *threads = t;
  *smem = thread_smem(N, D, q, q, bi, bh);
}

template <int RXT, int RPT>
int launch_thread(const float* x, const float* p, const EpilogueArgs& ea,
                  int B, int N, int D, int RX, int RP, float scale, int bi,
                  int bh, int nhb, int threads, size_t smem,
                  cudaStream_t st) {
  const cudaError_t e = allow_smem(cp_gram_kernel<RXT, RPT>, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((B + bi - 1) / bi) * nhb;
  // a row is whole float4s when its rank fills its padded width
  const int vecx = RX % 4 == 0 && RX == 4 * ((RXT + 3) / 4) && aligned16(x);
  const int vecp = RP % 4 == 0 && RP == 4 * ((RPT + 3) / 4) && aligned16(p);
  cp_gram_kernel<RXT, RPT><<<(unsigned)blocks, threads, smem, st>>>(
      x, p, ea, B, N, D, RX, RP, scale, bi, bh, nhb, vecx, vecp);
  return (int)cudaGetLastError();
}

template <int RXT, int RPT>
cudaError_t thread_occupancy(int threads, size_t smem, cudaFuncAttributes* a,
                             int* blocks) {
  cudaError_t e = cudaFuncGetAttributes(a, cp_gram_kernel<RXT, RPT>);
  if (e == cudaSuccess) e = allow_smem(cp_gram_kernel<RXT, RPT>, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, cp_gram_kernel<RXT, RPT>, threads, smem);
  return e;
}

}  // namespace

// block_items > 0: the thread kernel on blocks of block_items x
// block_hashes; block_items 0: the warp kernel on blocks of block_hashes
// warps (ranks above RMAX, or rows the thread kernel cannot stage). The
// caller planned threads and smem with its own copy of this file's shapes
// (cp_gram.py::plan); a plan that differs is refused. For the *-keys and
// srp-packed epilogues the caller hands in a zeroed output when the hash
// blocks cut a table (epilogue.cuh).
extern "C" int cp_gram_launch(const float* x, const float* p,
                              const float* offsets, const long long* mults,
                              void* out, int B, int N, int D, int RX, int L,
                              int K, int RP, int epilogue, float w,
                              float scale, int block_items, int block_hashes,
                              int threads, size_t smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (RX > RWARP || RP > RWARP) return (int)cudaErrorInvalidValue;
  int want_threads;
  size_t want_smem;
  plan_shape(N, D, RX, RP, block_items, block_hashes, &want_threads,
             &want_smem);
  if (want_threads == 0 || threads != want_threads || smem != want_smem)
    return (int)cudaErrorInvalidConfiguration;
  const EpilogueArgs ea{offsets, mults, out, L, K, epilogue, w};
  const int LK = L * K;
  const int nhb = (LK + block_hashes - 1) / block_hashes;
  if (block_items == 0) {
    const cudaError_t e = allow_smem(cp_gram_warp_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const int vecp = RP % 4 == 0 && aligned16(p);
    cp_gram_warp_kernel<<<(unsigned)((long long)B * nhb), threads, smem,
                          st>>>(x, p, ea, B, N, D, RX, RP, scale,
                                block_hashes, nhb, vecp);
    return (int)cudaGetLastError();
  }
  switch (inst_of(RX, RP)) {
    case 43:
      return launch_thread<4, 3>(x, p, ea, B, N, D, RX, RP, scale,
                                 block_items, block_hashes, nhb, threads,
                                 smem, st);
    case 44:
      return launch_thread<4, 4>(x, p, ea, B, N, D, RX, RP, scale,
                                 block_items, block_hashes, nhb, threads,
                                 smem, st);
    default:
      return launch_thread<RMAX, RMAX>(x, p, ea, B, N, D, RX, RP, scale,
                                       block_items, block_hashes, nhb,
                                       threads, smem, st);
  }
}

// Registers a thread, resident blocks per SM and local (spill) bytes a
// thread of the kernel a plan runs -> out[0..2].
extern "C" int cp_gram_occupancy(int N, int D, int RX, int RP,
                                 int block_items, int block_hashes,
                                 int* out) {
  int threads;
  size_t smem;
  plan_shape(N, D, RX, RP, block_items, block_hashes, &threads, &smem);
  if (threads == 0) return (int)cudaErrorInvalidConfiguration;
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t e;
  if (block_items == 0) {
    e = cudaFuncGetAttributes(&a, cp_gram_warp_kernel);
    if (e == cudaSuccess) e = allow_smem(cp_gram_warp_kernel, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, cp_gram_warp_kernel, threads, smem);
  } else {
    switch (inst_of(RX, RP)) {
      case 43: e = thread_occupancy<4, 3>(threads, smem, &a, &blocks); break;
      case 44: e = thread_occupancy<4, 4>(threads, smem, &a, &blocks); break;
      default:
        e = thread_occupancy<RMAX, RMAX>(threads, smem, &a, &blocks);
    }
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = (int)a.localSizeBytes;
  return 0;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
