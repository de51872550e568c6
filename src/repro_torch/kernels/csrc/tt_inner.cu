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
// R=4); at the cell's true ranks (1, 4, 4, 4, 1) that is 4736 FMA, 9.4
// kFLOP, per pair, so the fp32 rate outside the tensor cores (67 TFLOP/s)
// bounds it, far above the bytes' time at 3.35 TB/s.
//
// The thread kernel (ranks up to 8), tt_inner_kernel<R>. The first form
// staged 32 items' and one table's cores a mode and spent 55-60% of a
// block at the staging barriers; a thread read 32 scalar shared values for
// the 128 FMA of one pair's slice (the shared-memory pipe as busy as the
// FMA pipe), and an item's cores came from HBM once per table. Now:
//  - a block is (block items) x (block hashes) picked by the planner
//    (tt_inner.py::plan) from the launch's shape and the card's SM count,
//    at least two blocks a SM wherever the pairs allow; the grid walks the
//    hash blocks of one item block together (hash block fastest), so an
//    item's cores come from HBM once and from L2 after that;
//  - each thread holds a register tile of TI items x TH hashes (2 x 1 at
//    R = 4, 128 registers under __launch_bounds__(256, 2); 1 x 1 at
//    R = 8): a staged core row of a hash feeds two chains. A warp is 8
//    item lanes x 4 hash lanes, each row one float4 shared load that
//    touches 8 (or 4) distinct 16-byte slots;
//  - the stages hold kSlices slices of a mode (two buffers: the next is
//    staged while the current one computes), so a block's shared memory
//    leaves room for four query blocks a SM. Thread 0 stages each side
//    with one TMA copy of a 5-D tile (c, entity, slice, row, mode) of the
//    cores, which lands in the stage's layout and zero-fills the ragged
//    edges, completing on an mbarrier: with a cp.async per float4 a thread,
//    the warps spent about a quarter of their cycles waiting to issue the
//    copies behind the others' shared loads, and one bulk copy per 128-byte
//    chunk queued in the TMA unit. Rows of ranks below R go float by float
//    (cp.async) into the same layout; the stages are zeroed once, so
//    padding costs nothing later;
//  - per slice i a pair applies S <- S + Gx_i^T (S Gp_i), the product
//    S Gp_i in registers first, the chains of the tile's pairs interleaved;
//    mode 0 reads row 0 of both cores (S = e_00) and the last mode forms
//    only S[0, 0], as the padded chain computes;
//  - the scaled values go through shared memory to the block epilogue
//    (epilogue.cuh), which combines a table split over hash blocks exactly.
// Each pair runs the same FMA sequence as the first form (same slice and
// rank order), so raw values and keys are bit-equal to it. What bounds it
// now: the chain's FMA issue, about half the fp32 peak, with the shared
// loads of a 2 x 1 tile (48 floats a thread for 256 FMA a slice) next.
//
// The warp kernel (ranks 9-16), tt_inner_warp_kernel: a 16 x 16 state
// would take all of a thread's registers, so one warp steps one (item,
// hash) chain; a block holds one item and WB hashes (one warp each, the
// planner's WB), and
// stages the item's and its hashes' cores slice chunk by slice chunk
// (kWarpSlices slices a stage, cp.async, double-buffered). Lane l owns the
// 2 x 4 block (rows 2*(l/4), cols 4*(l%4)) of T = S Gp_i and of S', keeps
// its two rows of S in registers for the whole mode, and reads T's columns
// back from the warp's shared copy: per slice
//   T[a][e] = sum_b S[a][b] Gp[b][i][e],  S'[c][e] += sum_a Gx[a][i][c] T[a][e]
// (the first form's FMA order, so its values are unchanged). The first form
// ran one warp per (item, table) over its K chains in turn, reading every
// core entry by __ldg inside the FMA loop. What bounds it now: T's round
// trip through shared memory and the two __syncwarp a slice (about a tenth
// of the fp32 peak at R = 16); at Rp < 16 the padded rows are skipped, but
// the 2 x 4 lane blocks still cover 16 x 16.
//
// Rounding: inside the chain FMA contraction is allowed (raw values are held
// to a rounding bound, repro_torch/kernels/parity.py::tt_raw_bound); scale *
// v uses __fmul_rn, and the epilogue __fadd_rn / __fdiv_rn.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int RMAX = 8;          // largest rank (Rx, Rp) of the thread kernel
constexpr int RWARP = 16;        // largest rank of the warp kernel
constexpr int kSlices = 8;       // slices of a mode a thread-kernel stage holds
constexpr int kWarpBlockMax = 8;  // warps of a warp-kernel block, at most
constexpr int kWarpSlices = 4;   // slices of a mode a warp-kernel stage holds

template <int R>
struct Tile;  // tt_inner_kernel<R>: register tile, largest block
template <>
struct Tile<4> {
  static constexpr int TI = 2, TH = 1, threads = 256;
};
template <>
struct Tile<8> {
  static constexpr int TI = 1, TH = 1, threads = 128;
};

// A thread-kernel stage holds, for each core row a < R and slice ii of a
// chunk of DS = min(D, kSlices) slices, the rows of the block's entities
// (items, then hashes) side by side: row (a, ii) of entity e is the Q
// float4 units from ((a*DS + ii)*NE + e)*Q on (NE entities). That is the
// order of one TMA tile of the global cores seen as 5-D (c, entity, i, a,
// n), so one copy stages a side; lanes reading one row of 8 (or 4)
// consecutive entities touch consecutive 16-byte slots.
__host__ __device__ inline int stage_slices(int D) {
  return D < kSlices ? D : kSlices;
}

// Shared bytes of a thread-kernel block: 128 bytes for the stages' two
// mbarriers, then two stages of its items' and hashes' rows, or the
// block's scaled values, whichever is larger.
size_t thread_smem(int R, int D, int bi, int bh) {
  const size_t stage = (size_t)R * stage_slices(D) * (bi + bh) * R;
  return 128 + max_bytes(2 * stage * sizeof(float),
                         (size_t)bi * bh * sizeof(float));
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
}

// The stage's one arrival, announcing the bytes its copies will bring.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA copy of the tile at (c0, c1, c2, c3, c4) of a 5-D tensor map
// into shared memory, completing on bar (out-of-range elements are zeros).
__device__ __forceinline__ void tma_5d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, int c3,
                                       int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(smem_addr(bar))
      : "memory");
}

// Without a tensor map (ranks below the padded R, or unaligned rows): the
// same layout float by float with cp.async; the block zeroed the stages,
// so padding stays zero. Entity e's row a slice i: ract floats at
// g + e*estride + (a*D + i)*ract.
template <int R>
__device__ __forceinline__ void stage_floats(float* s, int NE, int DS,
                                             const float* g,
                                             long long estride, int D,
                                             int i0, int ns, int ract,
                                             int nvalid) {
  const int rows = ract < R ? ract : R, per = rows * ns * ract;
  for (int j = threadIdx.x; j < nvalid * per; j += blockDim.x) {
    const int e = j / per, r = j - e * per;
    const int a = r / (ns * ract), f = r - a * (ns * ract);
    const int ii = f / ract, c = f - ii * ract;
    cp_async4(s + ((size_t)(a * DS + ii) * NE + e) * R + c,
              g + e * estride + (long long)(a * D + i0 + ii) * ract + c);
  }
}

// Shared bytes of a warp-kernel block of wb warps: two stages of the item's
// and wb hashes' slice chunks, each warp's S and T, the block's values.
size_t warp_smem(int wb) {
  return (2 * (size_t)(1 + wb) * kWarpSlices * RWARP * RWARP +
          (size_t)wb * 2 * RWARP * RWARP + wb) *
         sizeof(float);
}

template <int R>
__global__ void __launch_bounds__(Tile<R>::threads, 2)
tt_inner_kernel(const float* __restrict__ x,  // (B, N, RX, D, RX)
                const float* __restrict__ p,  // (N, L*K, RP, D, RP)
                EpilogueArgs ea, int B, int N, int D, int RX, int RP,
                float scale, int BI, int BH, int nhb,
                const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap pmap, int vecx,
                int vecp) {
  constexpr int TI = Tile<R>::TI, TH = Tile<R>::TH, Q = R / 4;
  extern __shared__ __align__(128) float4 smem4[];
  const int LK = ea.L * ea.K;
  const int hb = blockIdx.x % nhb;  // hash blocks of one item block together
  const long long z0 = (long long)(blockIdx.x / nhb) * BI;
  const int h0 = hb * BH, nh = min(BH, LK - h0);
  const int nz = (int)min((long long)BI, (long long)B - z0);
  const int DS = stage_slices(D);
  const size_t xunits = (size_t)R * DS * BI * Q;  // a stage: items, hashes
  const size_t units = xunits + (size_t)R * DS * BH * Q;
  const int FX = RX * D * RX, FP = RP * D * RP;
  const float* xg = x + z0 * N * FX;
  const float* pg = p + (size_t)h0 * FP;
  const int nch = (D + kSlices - 1) / kSlices, steps = N * nch;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);
  float4* stg = smem4 + 8;  // 128 bytes on

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = BI / (kItemLanes * TI);
  const int zi = (warp % wn) * kItemLanes * TI + (lane & 7);  // + 8 t
  const int hi = (warp / wn) * kHashLanes * TH + (lane >> 3);  // + 4 u
  const bool active = zi < nz && hi < nh;
  const bool tma = vecx || vecp;
  const unsigned tx = (unsigned)((vecx ? xunits : 0) +
                                 (vecp ? units - xunits : 0)) *
                      sizeof(float4);

  // zeroed stages: rows and columns past the true ranks stay zero
  for (size_t j = threadIdx.x; j < 2 * units; j += blockDim.x)
    stg[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage(step, buf): slices [i0, i0 + ns) of mode n of the block's items
  // and hashes: one TMA tile a side (thread 0), or float by float
  auto stage = [&](int step, int buf) {
    const int n = step / nch, i0 = (step - n * nch) * kSlices;
    const int ns = min(kSlices, D - i0);
    float4* xs = stg + buf * units;
    float4* ps = xs + xunits;
    if (tma && threadIdx.x == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive_tx(bars + buf, tx);
      if (vecx) tma_5d(xs, &xmap, 0, (int)z0, i0, 0, n, bars + buf);
      if (vecp) tma_5d(ps, &pmap, 0, h0, i0, 0, n, bars + buf);
    }
    if (!vecx)
      stage_floats<R>(reinterpret_cast<float*>(xs), BI, DS,
                      xg + (size_t)n * FX, (long long)N * FX, D, i0, ns, RX,
                      nz);
    if (!vecp)
      stage_floats<R>(reinterpret_cast<float*>(ps), BH, DS,
                      pg + (size_t)n * LK * FP, FP, D, i0, ns, RP, nh);
    cp_async_commit();
  };

  float s[TI][TH][R][R], sn[TI][TH][R][R], acc[TI][TH];
  stage(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int n = step / nch, ch = step - n * nch;
    const int ns = min(kSlices, D - ch * kSlices);
    if (step + 1 < steps) {
      stage(step + 1, (step + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (tma) mbar_wait(bars + (step & 1), (step >> 1) & 1);
    __syncthreads();
    // row (a, ii) of item zi + 8t: xb[((a*DS + ii)*BI + 8t)*Q + q]; of hash
    // hi + 4u: pb[((a*DS + ii)*BH + 4u)*Q + q]
    const float4* xb = stg + (step & 1) * units + (size_t)zi * Q;
    const float4* pb = stg + (step & 1) * units + xunits + (size_t)hi * Q;
    if (active && n == 0) {
      // S = e_00: S'[c][e] = sum_i Gx[0][i][c] Gp[0][i][e]
      if (ch == 0) {
#pragma unroll
        for (int t = 0; t < TI; ++t)
#pragma unroll
          for (int u = 0; u < TH; ++u)
#pragma unroll
            for (int c = 0; c < R; ++c)
#pragma unroll
              for (int e = 0; e < R; ++e) s[t][u][c][e] = 0.f;
      }
      for (int ii = 0; ii < ns; ++ii) {
        float4 pr[TH][Q], xr[TI][Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
#pragma unroll
          for (int u = 0; u < TH; ++u)
            pr[u][q] = pb[((size_t)ii * BH + 4 * u) * Q + q];
#pragma unroll
          for (int t = 0; t < TI; ++t)
            xr[t][q] = xb[((size_t)ii * BI + 8 * t) * Q + q];
        }
#pragma unroll
        for (int c = 0; c < R; ++c)
#pragma unroll
          for (int e = 0; e < R; ++e)
#pragma unroll
            for (int t = 0; t < TI; ++t)
#pragma unroll
              for (int u = 0; u < TH; ++u)
                s[t][u][c][e] =
                    fmaf(comp(xr[t], c), comp(pr[u], e), s[t][u][c][e]);
      }
    } else if (active && n == N - 1) {
      // only S'[0][0] = sum_i sum_a Gx[a][i][0] sum_b S[a][b] Gp[b][i][0]
      if (ch == 0) {
#pragma unroll
        for (int t = 0; t < TI; ++t)
#pragma unroll
          for (int u = 0; u < TH; ++u) acc[t][u] = 0.f;
      }
      for (int ii = 0; ii < ns; ++ii) {
        float pv[TH][R], xv[TI][R];
#pragma unroll
        for (int b = 0; b < R; ++b) {
#pragma unroll
          for (int u = 0; u < TH; ++u)
            pv[u][b] = pb[((size_t)(b * DS + ii) * BH + 4 * u) * Q].x;
#pragma unroll
          for (int t = 0; t < TI; ++t)
            xv[t][b] = xb[((size_t)(b * DS + ii) * BI + 8 * t) * Q].x;
        }
        float tv[TI][TH][R];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int t = 0; t < TI; ++t)
#pragma unroll
            for (int u = 0; u < TH; ++u) tv[t][u][a] = 0.f;
#pragma unroll
        for (int b = 0; b < R; ++b)
#pragma unroll
          for (int a = 0; a < R; ++a)
#pragma unroll
            for (int t = 0; t < TI; ++t)
#pragma unroll
              for (int u = 0; u < TH; ++u)
                tv[t][u][a] = fmaf(s[t][u][a][b], pv[u][b], tv[t][u][a]);
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int t = 0; t < TI; ++t)
#pragma unroll
            for (int u = 0; u < TH; ++u)
              acc[t][u] = fmaf(xv[t][a], tv[t][u][a], acc[t][u]);
      }
    } else if (active) {
      if (ch == 0) {
#pragma unroll
        for (int t = 0; t < TI; ++t)
#pragma unroll
          for (int u = 0; u < TH; ++u)
#pragma unroll
            for (int c = 0; c < R; ++c)
#pragma unroll
              for (int e = 0; e < R; ++e) sn[t][u][c][e] = 0.f;
      }
      for (int ii = 0; ii < ns; ++ii) {
        float4 pr[TH][R][Q];  // rows b of Gp_i
#pragma unroll
        for (int b = 0; b < R; ++b)
#pragma unroll
          for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int u = 0; u < TH; ++u)
              pr[u][b][q] = pb[((size_t)(b * DS + ii) * BH + 4 * u) * Q + q];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          float4 xr[TI][Q];  // row a of Gx_i
#pragma unroll
          for (int q = 0; q < Q; ++q)
#pragma unroll
            for (int t = 0; t < TI; ++t)
              xr[t][q] = xb[((size_t)(a * DS + ii) * BI + 8 * t) * Q + q];
          // (S Gp_i)[a][:] of every pair, the chains over b interleaved
          float tv[TI][TH][R];
#pragma unroll
          for (int e = 0; e < R; ++e)
#pragma unroll
            for (int t = 0; t < TI; ++t)
#pragma unroll
              for (int u = 0; u < TH; ++u) tv[t][u][e] = 0.f;
#pragma unroll
          for (int b = 0; b < R; ++b)
#pragma unroll
            for (int e = 0; e < R; ++e)
#pragma unroll
              for (int t = 0; t < TI; ++t)
#pragma unroll
                for (int u = 0; u < TH; ++u)
                  tv[t][u][e] =
                      fmaf(s[t][u][a][b], comp(pr[u][b], e), tv[t][u][e]);
#pragma unroll
          for (int c = 0; c < R; ++c)
#pragma unroll
            for (int e = 0; e < R; ++e)
#pragma unroll
              for (int t = 0; t < TI; ++t)
#pragma unroll
                for (int u = 0; u < TH; ++u)
                  sn[t][u][c][e] =
                      fmaf(comp(xr[t], c), tv[t][u][e], sn[t][u][c][e]);
        }
      }
      if (ch == nch - 1) {
#pragma unroll
        for (int t = 0; t < TI; ++t)
#pragma unroll
          for (int u = 0; u < TH; ++u)
#pragma unroll
            for (int c = 0; c < R; ++c)
#pragma unroll
              for (int e = 0; e < R; ++e) s[t][u][c][e] = sn[t][u][c][e];
      }
    }
    __syncthreads();  // every thread is done with this buffer
  }

  // epilogue: the scaled values through shared memory (the stage buffers)
  float* vs = reinterpret_cast<float*>(stg);  // [BI][BH]
  if (active) {
#pragma unroll
    for (int t = 0; t < TI; ++t)
#pragma unroll
      for (int u = 0; u < TH; ++u)
        if (zi + 8 * t < nz && hi + 4 * u < nh)
          vs[(zi + 8 * t) * BH + hi + 4 * u] =
              __fmul_rn(scale, N == 1 ? s[t][u][0][0] : acc[t][u]);
  }
  __syncthreads();
  block_epilogue(ea, vs, BH, z0, nz, h0, h0 + nh);
}

// Ranks above RMAX: one warp per (item, hash); a block holds one item and
// WB hashes (see the header).
__global__ void __launch_bounds__(kWarpBlockMax * 32)
tt_inner_warp_kernel(const float* __restrict__ x,  // (B, N, RX, D, RX)
                     const float* __restrict__ p,  // (N, L*K, RP, D, RP)
                     EpilogueArgs ea, int B, int N, int D, int RX, int RP,
                     float scale, int WB, int nhb, int vecx, int vecp) {
  constexpr int R = RWARP, Q = R / 4, SL = kWarpSlices * R * R;
  extern __shared__ float4 smem4[];
  float* stg = reinterpret_cast<float*>(smem4);  // [2][1 + WB][slice][a][c]
  float* st = stg + 2 * (1 + WB) * SL;           // [WB][S, T][R*R]
  float* vs = st + WB * 2 * R * R;               // [WB]
  const int LK = ea.L * ea.K;
  const int hb = blockIdx.x % nhb;
  const long long z = blockIdx.x / nhb;
  const int h0 = hb * WB, nh = min(WB, LK - h0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = warp < nh;
  const int FX = RX * D * RX, FP = RP * D * RP;
  const int nchunks = (D + kWarpSlices - 1) / kWarpSlices;
  const int steps = N * nchunks;

  // stage(step, buf): slices [i0, i0 + ns) of mode n, the item (entity 0)
  // and the block's hashes (entities 1..nh), rows a < R, cols c < R, zeros
  // past the true ranks
  auto stage = [&](int step, int buf) {
    const int n = step / nchunks, i0 = (step - n * nchunks) * kWarpSlices;
    const int ns = min(kWarpSlices, D - i0);
    const int per = ns * R * Q;
    for (int j = threadIdx.x; j < (1 + nh) * per; j += blockDim.x) {
      const int e = j / per, u = j - e * per;
      const int ii = u / (R * Q), a = (u - ii * R * Q) / Q, q = u % Q;
      float* dst = stg + (size_t)((buf * (1 + WB) + e) * kWarpSlices + ii) *
                             R * R + a * R + 4 * q;
      const int ract = e ? RP : RX;
      const float* src =
          (e ? p + ((size_t)n * LK + h0 + e - 1) * FP
             : x + ((size_t)z * N + n) * FX) +
          ((size_t)a * D + i0 + ii) * ract + 4 * q;
      if (a >= ract) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (e ? vecp : vecx) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (4 * q + c < ract)
            cp_async4(dst + c, src + c);
          else
            dst[c] = 0.f;
        }
      }
    }
    cp_async_commit();
  };

  const int c0 = 2 * (lane >> 2), e0 = 4 * (lane & 3);
  float* S = st + warp * 2 * R * R;  // [a][b]
  float* T = S + R * R;              // [a][e]
  float srow[2][R];  // rows c0, c0 + 1 of S (mode 0 needs none: S = e_00)
  float acc[2][4];   // S'[c0 + r][e0 + q]

  stage(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int n = step / nchunks, ch = step - n * nchunks;
    if (step + 1 < steps) {
      stage(step + 1, (step + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (ch == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    }
    const float* xst = stg + (size_t)((step & 1) * (1 + WB)) * SL;
    const float* pst = xst + (size_t)(1 + warp) * SL;
    const int ns = min(kWarpSlices, D - ch * kWarpSlices);
    if (live) {
      for (int ii = 0; ii < ns; ++ii) {
        const float* xi = xst + ii * R * R;  // Gx[a][i][c] at xi[a*R + c]
        const float* pi = pst + ii * R * R;  // Gp[b][i][e] at pi[b*R + e]
        if (n == 0) {
          // S = e_00: S'[c][e] += Gx[0][i][c] Gp[0][i][e]
          const float2 xv = *reinterpret_cast<const float2*>(xi + c0);
          const float4 pv = *reinterpret_cast<const float4*>(pi + e0);
          const float xa[2] = {xv.x, xv.y}, pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[r][q] = __fadd_rn(acc[r][q], __fmul_rn(xa[r], pa[q]));
          continue;
        }
        float tv[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) tv[r][q] = 0.f;
#pragma unroll
        for (int b = 0; b < R; ++b) {
          if (b >= RP) break;  // the padded rows of Gp_i are zeros
          const float4 pv = *reinterpret_cast<const float4*>(pi + b * R + e0);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            tv[r][0] = fmaf(srow[r][b], pv.x, tv[r][0]);
            tv[r][1] = fmaf(srow[r][b], pv.y, tv[r][1]);
            tv[r][2] = fmaf(srow[r][b], pv.z, tv[r][2]);
            tv[r][3] = fmaf(srow[r][b], pv.w, tv[r][3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float4*>(T + (c0 + r) * R + e0) =
              make_float4(tv[r][0], tv[r][1], tv[r][2], tv[r][3]);
        __syncwarp();
        if (n < N - 1) {
          float u[2][4];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) u[r][q] = 0.f;
#pragma unroll
          for (int a = 0; a < R; ++a) {
            if (a >= RX) break;  // the padded rows of Gx_i are zeros
            const float2 xv = *reinterpret_cast<const float2*>(xi + a * R + c0);
            const float4 t4 = *reinterpret_cast<const float4*>(T + a * R + e0);
            const float xa[2] = {xv.x, xv.y};
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              u[r][0] = fmaf(xa[r], t4.x, u[r][0]);
              u[r][1] = fmaf(xa[r], t4.y, u[r][1]);
              u[r][2] = fmaf(xa[r], t4.z, u[r][2]);
              u[r][3] = fmaf(xa[r], t4.w, u[r][3]);
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[r][q] = __fadd_rn(acc[r][q], u[r][q]);
        } else if (lane == 0) {
          // the last mode: only S'[0][0]
          float u = 0.f;
#pragma unroll
          for (int a = 0; a < R; ++a)
            if (a < RX) u = fmaf(xi[a * R], T[a * R], u);
          acc[0][0] = __fadd_rn(acc[0][0], u);
        }
        __syncwarp();  // T is read before the next slice writes it
      }
      if (ch == nchunks - 1 && n < N - 1) {
        // the mode's S' becomes S: through the warp's copy to rows c0, c0+1
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float4*>(S + (c0 + r) * R + e0) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int b = 0; b < R; ++b) srow[r][b] = S[(c0 + r) * R + b];
        __syncwarp();
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  if (live && lane == 0) vs[warp] = __fmul_rn(scale, acc[0][0]);
  __syncthreads();
  block_epilogue(ea, vs, WB, z, 1, h0, h0 + nh);
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A 5-D fp32 tensor map over base: dims[0] contiguous, strides of dims
// 1-4 in floats, tiles of box; out-of-range elements read as zeros.
cudaError_t encode_5d(CUtensorMap* map, const float* base,
                      const cuuint64_t dims[5], const cuuint64_t strides[4],
                      const cuuint32_t box[5]) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t bytes[4] = {strides[0] * 4, strides[1] * 4,
                               strides[2] * 4, strides[3] * 4};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(base), dims,
      bytes, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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

// The thread kernel's padded rank for these ranks, or 0: the warp kernel.
int rank_of(int RX, int RP) {
  const int r = RX > RP ? RX : RP;
  return r <= 4 ? 4 : r <= RMAX ? RMAX : 0;
}

// Threads and shared bytes of a plan (block_items 0: the warp kernel with
// block_hashes warps), or threads 0 if the plan is not one of the kernel's.
void plan_shape(int D, int RX, int RP, int bi, int bh, int* threads,
                size_t* smem) {
  *threads = 0;
  *smem = 0;
  const int R = rank_of(RX, RP);
  if (bi == 0) {
    if (bh >= 1 && bh <= kWarpBlockMax) {
      *threads = 32 * bh;
      *smem = warp_smem(bh);
    }
    return;
  }
  if (R == 0) return;
  const int t = R == 4 ? tile_threads(bi, bh, Tile<4>::TI, Tile<4>::TH)
                       : tile_threads(bi, bh, Tile<8>::TI, Tile<8>::TH);
  if (t == 0 || t > (R == 4 ? Tile<4>::threads : Tile<8>::threads)) return;
  *threads = t;
  *smem = thread_smem(R, D, bi, bh);
}

}  // namespace

// block_items > 0: the thread kernel on blocks of block_items x
// block_hashes; block_items 0: the warp kernel on blocks of block_hashes
// warps (ranks above RMAX). The
// caller planned threads and smem with its own copy of this file's shapes
// (tt_inner.py::plan); a plan that differs is refused. For the *-keys and
// srp-packed epilogues the caller hands in a zeroed output when the hash
// blocks cut a table (epilogue.cuh).
extern "C" int tt_inner_launch(const float* x, const float* p,
                               const float* offsets, const long long* mults,
                               void* out, int B, int N, int D, int RX, int L,
                               int K, int RP, int epilogue, float w,
                               float scale, int block_items, int block_hashes,
                               int threads, size_t smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (RX > RWARP || RP > RWARP) return (int)cudaErrorInvalidValue;
  int want_threads;
  size_t want_smem;
  plan_shape(D, RX, RP, block_items, block_hashes, &want_threads, &want_smem);
  if (want_threads == 0 || threads != want_threads || smem != want_smem)
    return (int)cudaErrorInvalidConfiguration;
  const EpilogueArgs ea{offsets, mults, out, L, K, epilogue, w};
  const int LK = L * K;
  const int nhb = (LK + block_hashes - 1) / block_hashes;
  int vecp = (RP == 4 || RP == 8 || RP == 16) && aligned16(p);
  int vecx = (RX == 4 || RX == 8 || RX == 16) && aligned16(x);
  cudaError_t e;
  if (block_items == 0) {
    e = allow_smem(tt_inner_warp_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (long long)B * nhb;
    tt_inner_warp_kernel<<<(unsigned)blocks, threads, smem, st>>>(
        x, p, ea, B, N, D, RX, RP, scale, block_hashes, nhb,
        vecx && RX == RWARP, vecp && RP == RWARP);
    return (int)cudaGetLastError();
  }
  const long long blocks =
      (long long)((B + block_items - 1) / block_items) * nhb;
  // the thread kernel stages rows of the padded rank R through tensor maps
  // (c, item, i, a, n) and (e, hash, i, b, n) where they are whole
  const int R = rank_of(RX, RP), DS = stage_slices(D);
  vecx = vecx && RX == R;
  vecp = vecp && RP == R;
  CUtensorMap xmap{}, pmap{};
  if (vecx) {
    const cuuint64_t dims[5] = {(cuuint64_t)RX, (cuuint64_t)B, (cuuint64_t)D,
                                (cuuint64_t)RX, (cuuint64_t)N};
    const cuuint64_t fx = (cuuint64_t)RX * D * RX;
    const cuuint64_t strides[4] = {N * fx, (cuuint64_t)RX,
                                   (cuuint64_t)D * RX, fx};
    const cuuint32_t box[5] = {(cuuint32_t)R, (cuuint32_t)block_items,
                               (cuuint32_t)DS, (cuuint32_t)R, 1};
    e = encode_5d(&xmap, x, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  if (vecp) {
    const cuuint64_t dims[5] = {(cuuint64_t)RP, (cuuint64_t)LK,
                                (cuuint64_t)D, (cuuint64_t)RP, (cuuint64_t)N};
    const cuuint64_t fp = (cuuint64_t)RP * D * RP;
    const cuuint64_t strides[4] = {fp, (cuuint64_t)RP, (cuuint64_t)D * RP,
                                   LK * fp};
    const cuuint32_t box[5] = {(cuuint32_t)R, (cuuint32_t)block_hashes,
                               (cuuint32_t)DS, (cuuint32_t)R, 1};
    e = encode_5d(&pmap, p, dims, strides, box);
    if (e != cudaSuccess) return (int)e;
  }
  if (R == 4) {
    e = allow_smem(tt_inner_kernel<4>, smem);
    if (e != cudaSuccess) return (int)e;
    tt_inner_kernel<4><<<(unsigned)blocks, threads, smem, st>>>(
        x, p, ea, B, N, D, RX, RP, scale, block_items, block_hashes, nhb,
        xmap, pmap, vecx, vecp);
  } else {
    e = allow_smem(tt_inner_kernel<RMAX>, smem);
    if (e != cudaSuccess) return (int)e;
    tt_inner_kernel<RMAX><<<(unsigned)blocks, threads, smem, st>>>(
        x, p, ea, B, N, D, RX, RP, scale, block_items, block_hashes, nhb,
        xmap, pmap, vecx, vecp);
  }
  return (int)cudaGetLastError();
}

// Registers a thread, resident blocks per SM and local (spill) bytes a
// thread of the kernel a plan runs -> out[0..2].
extern "C" int tt_inner_occupancy(int D, int RX, int RP, int block_items,
                                  int block_hashes, int* out) {
  int threads;
  size_t smem;
  plan_shape(D, RX, RP, block_items, block_hashes, &threads, &smem);
  if (threads == 0) return (int)cudaErrorInvalidConfiguration;
  cudaFuncAttributes a;
  int blocks = 0;
  cudaError_t e;
  if (block_items == 0) {
    e = cudaFuncGetAttributes(&a, tt_inner_warp_kernel);
    if (e == cudaSuccess) e = allow_smem(tt_inner_warp_kernel, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tt_inner_warp_kernel, threads, smem);
  } else if (rank_of(RX, RP) == 4) {
    e = cudaFuncGetAttributes(&a, tt_inner_kernel<4>);
    if (e == cudaSuccess) e = allow_smem(tt_inner_kernel<4>, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tt_inner_kernel<4>, threads, smem);
  } else {
    e = cudaFuncGetAttributes(&a, tt_inner_kernel<RMAX>);
    if (e == cudaSuccess) e = allow_smem(tt_inner_kernel<RMAX>, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tt_inner_kernel<RMAX>, threads, smem);
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = (int)a.localSizeBytes;
  return 0;
}
