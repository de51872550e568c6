// The fused hash epilogue shared by K3 (cp_gram.cu) and K4 (tt_inner.cu):
// the CUDA form of repro/kernels/epilogues.py::apply_epilogue.
//
// One (item, table) is fed its K scaled raw values in k order and stores
// what the epilogue asks for: the raw values, E2LSH codes floor((v + b) / w),
// SRP bits v > 0, the uint32 radix key sum_k code_k * mults[k] (natural
// uint32 wraparound, exactly repro.core.lsh._combine_codes), or the SRP bits
// packed little-endian into uint32 words. Keys and words are stored as
// int64 holding the uint32 value.
//
// A kernel that splits a table's K hashes over blocks (K3 and K4 tile K
// when one table does not fit a block) passes the chunk's end and
// chunked = 1: each block then adds its partial key into the low uint32
// word of the zero-initialised int64 output (atomicAdd wraps mod 2^32, and
// sum_k code_k * mults[k] mod 2^32 is the same whatever the grouping) and
// ORs its bits into the packed words, so the chunks combine exactly. With
// chunked = 0 every output is a plain store.
//
// Rounding: v + b uses __fadd_rn, so that the compiler cannot contract it
// with the caller's scale multiply into one FMA, and the division by w is
// __fdiv_rn (IEEE, never a multiply by 1/w), as in the reference; otherwise
// codes next to bucket edges flip.

#pragma once

#include <stdint.h>

namespace {

enum Epilogue : int {
  kRaw = 0, kE2lsh = 1, kSrp = 2, kE2lshKeys = 3, kSrpKeys = 4, kSrpPacked = 5
};

struct EpilogueArgs {
  const float* offsets;     // (L, K), E2LSH only
  const long long* mults;   // (K,) uint32 values, *-keys only
  void* out;
  int L, K, epilogue;
  float w;
  int kend = 0;             // end of this block's hashes (chunked only)
  int chunked = 0;          // 1: partial keys / words combine atomically
};

// The low uint32 word of an int64 output cell (little-endian).
__device__ __forceinline__ unsigned int* low_word(void* out, size_t cell) {
  return reinterpret_cast<unsigned int*>(static_cast<long long*>(out) + cell);
}

struct EpilogueTail {
  uint32_t key = 0u, word = 0u;

  // v is the scaled raw value of code k of item z in table l.
  __device__ __forceinline__ void push(const EpilogueArgs& e, long long z,
                                       int l, int k, float v) {
    const size_t cell = ((size_t)z * e.L + l) * e.K + k;
    if (e.epilogue == kRaw) {
      static_cast<float*>(e.out)[cell] = v;
      return;
    }
    int code;
    if (e.epilogue == kE2lsh || e.epilogue == kE2lshKeys) {
      code = (int)floorf(
          __fdiv_rn(__fadd_rn(v, e.offsets[l * e.K + k]), e.w));
    } else {
      code = v > 0.f ? 1 : 0;
    }
    if (e.epilogue == kE2lsh || e.epilogue == kSrp) {
      static_cast<int*>(e.out)[cell] = code;
    } else if (e.epilogue == kSrpPacked) {
      word |= (uint32_t)code << (k & 31);
      if ((k & 31) == 31 || k == e.K - 1 || (e.chunked && k == e.kend - 1)) {
        const int words = (e.K + 31) / 32;
        const size_t wc = ((size_t)z * e.L + l) * words + (k >> 5);
        if (e.chunked)
          atomicOr(low_word(e.out, wc), word);
        else
          static_cast<long long*>(e.out)[wc] = (long long)word;
        word = 0u;
      }
    } else {
      key += (uint32_t)code * (uint32_t)e.mults[k];
    }
  }

  // After the table's last code: stores the radix key (*-keys modes).
  __device__ __forceinline__ void finish(const EpilogueArgs& e, long long z,
                                         int l) const {
    if (e.epilogue != kE2lshKeys && e.epilogue != kSrpKeys) return;
    const size_t cell = (size_t)z * e.L + l;
    if (e.chunked)
      atomicAdd(low_word(e.out, cell), key);
    else
      static_cast<long long*>(e.out)[cell] = (long long)key;
  }
};

}  // namespace
