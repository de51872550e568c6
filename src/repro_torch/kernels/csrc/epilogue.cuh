// What K3 (cp_gram.cu) and K4 (tt_inner.cu) share: the fused hash
// epilogue (the CUDA form of repro/kernels/epilogues.py::apply_epilogue),
// the staging of a block's rows into shared memory, and the block's plan.
//
// Epilogue. A block owns the items [z0, z0 + nz) and the flattened hashes
// [h0, h1) (h = l*K + k) of one launch, and hands it their scaled raw values
// in shared memory. It stores what the epilogue asks for: the raw values,
// E2LSH codes floor((v + b) / w), SRP bits v > 0 (one per (item, hash),
// hash fastest, so neighbouring threads store neighbouring cells), the
// uint32 radix key sum_k code_k * mults[k] (natural uint32 wraparound,
// exactly repro.core.lsh._combine_codes) or the SRP bits packed
// little-endian into uint32 words (one thread per (item, table segment)).
// Keys and words are stored as int64 holding the uint32 value. A table
// whose hashes the block holds whole is stored plainly; a part of a table
// (a hash block that begins or ends inside it) adds its partial key into
// the low uint32 word of the zero-initialised int64 output (atomicAdd wraps
// mod 2^32, and sum_k code_k * mults[k] mod 2^32 is the same whatever the
// grouping) and ORs its bits into the packed words, so the parts combine
// exactly. The wrapper zeroes the output exactly when some block cuts a
// table: L*K > hashes per block and K does not divide the hashes per block.
//
// Rounding: v + b uses __fadd_rn, so that the compiler cannot contract it
// with the caller's scale multiply into one FMA, and the division by w is
// __fdiv_rn (IEEE, never a multiply by 1/w), as in the reference; otherwise
// codes next to bucket edges flip.
//
// Staging. Both kernels copy their rows into shared memory with cp.async
// (16 bytes where a row is whole float4s and aligned, else 4 bytes a
// float) and read them back as float4 rows; each kernel lays its stages
// out so that the lanes of one load touch distinct 16-byte bank groups.
//
// Plan. A thread kernel's warp is 8 item lanes x 4 hash lanes; with a
// register tile of TI items x TH hashes a thread it covers 8*TI items x
// 4*TH hashes, and a block's warps tile (block items) x (block hashes).
// The Python planners (cp_gram.plan, tt_inner.plan) pick the block from
// the launch's shape and the card's SM count; the C launches recompute the
// threads and shared bytes and refuse a plan that differs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Epilogue : int {
  kRaw = 0, kE2lsh = 1, kSrp = 2, kE2lshKeys = 3, kSrpKeys = 4, kSrpPacked = 5
};

constexpr int kItemLanes = 8;   // a thread kernel's warp: 8 item lanes
constexpr int kHashLanes = 4;   // x 4 hash lanes

struct EpilogueArgs {
  const float* offsets;     // (L*K,), E2LSH only
  const long long* mults;   // (K,) uint32 values, *-keys only
  void* out;
  int L, K, epilogue;
  float w;
};

// The low uint32 word of an int64 output cell (little-endian).
__device__ __forceinline__ unsigned int* low_word(void* out, size_t cell) {
  return reinterpret_cast<unsigned int*>(static_cast<long long*>(out) + cell);
}

// The code of flattened hash h at scaled raw value v.
__device__ __forceinline__ int hash_code(const EpilogueArgs& e, int h,
                                         float v) {
  if (e.epilogue == kE2lsh || e.epilogue == kE2lshKeys)
    return (int)floorf(__fdiv_rn(__fadd_rn(v, e.offsets[h]), e.w));
  return v > 0.f ? 1 : 0;
}

// vs[zi * ldv + (h - h0)]: the scaled raw value of item z0 + zi, hash h.
// Every thread of the block calls it after a barrier.
__device__ void block_epilogue(const EpilogueArgs& e, const float* vs,
                               int ldv, long long z0, int nz, int h0, int h1) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int LK = e.L * e.K, nh = h1 - h0;
  if (e.epilogue == kRaw || e.epilogue == kE2lsh || e.epilogue == kSrp) {
    for (int j = tid; j < nz * nh; j += nthreads) {
      const int zi = j / nh, hi = j - zi * nh;
      const size_t cell = (size_t)(z0 + zi) * LK + h0 + hi;
      const float v = vs[zi * ldv + hi];
      if (e.epilogue == kRaw)
        static_cast<float*>(e.out)[cell] = v;
      else
        static_cast<int*>(e.out)[cell] = hash_code(e, h0 + hi, v);
    }
    return;
  }
  const int l0 = h0 / e.K, nseg = (h1 - 1) / e.K + 1 - l0;
  const int words = (e.K + 31) / 32;
  for (int j = tid; j < nz * nseg; j += nthreads) {
    const int zi = j / nseg, l = l0 + (j - zi * nseg);
    const int kb = max(h0, l * e.K) - l * e.K;
    const int ke = min(h1, (l + 1) * e.K) - l * e.K;
    const bool part = kb > 0 || ke < e.K;
    const long long z = z0 + zi;
    const float* v = vs + zi * ldv + (l * e.K - h0);
    if (e.epilogue == kSrpPacked) {
      uint32_t word = 0u;
      for (int k = kb; k < ke; ++k) {
        word |= (uint32_t)hash_code(e, l * e.K + k, v[k]) << (k & 31);
        if ((k & 31) == 31 || k == ke - 1) {
          const size_t wc = ((size_t)z * e.L + l) * words + (k >> 5);
          if (part)
            atomicOr(low_word(e.out, wc), word);
          else
            static_cast<long long*>(e.out)[wc] = (long long)word;
          word = 0u;
        }
      }
    } else {
      uint32_t key = 0u;
      for (int k = kb; k < ke; ++k)
        key += (uint32_t)hash_code(e, l * e.K + k, v[k]) *
               (uint32_t)e.mults[k];
      const size_t cell = (size_t)z * e.L + l;
      if (part)
        atomicAdd(low_word(e.out, cell), key);
      else
        static_cast<long long*>(e.out)[cell] = (long long)key;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The component c (compile-time after unrolling) of a row held as float4s.
__device__ __forceinline__ float comp(const float4* v, int c) {
  const float4 q = v[c >> 2];
  switch (c & 3) {
    case 0: return q.x;
    case 1: return q.y;
    case 2: return q.z;
    default: return q.w;
  }
}

// The larger of two byte counts (a block's stages or its scaled values,
// which reuse the stages' memory).
__host__ __device__ inline size_t max_bytes(size_t a, size_t b) {
  return a > b ? a : b;
}

// Threads of a thread-kernel block of bi items x bh hashes with a TI x TH
// register tile, or 0 if the block is not whole warps of that tile.
inline int tile_threads(int bi, int bh, int TI, int TH) {
  const int wi = kItemLanes * TI, wh = kHashLanes * TH;
  if (bi <= 0 || bh <= 0 || bi % wi || bh % wh) return 0;
  return (bi / wi) * (bh / wh) * 32;
}

}  // namespace
