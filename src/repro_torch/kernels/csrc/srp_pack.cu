// K6: SRP sign bits packed little-endian into uint32 words, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/srp_pack.py::_srp_pack_kernel (the
// pl.pallas_call in srp_pack_pallas, wrapped by repro/kernels/ops.py's
// srp_pack). For values (B, K) float32 it stores (B, ceil(K/32)) words:
// bit j of word w of row b is values[b, 32w + j] > 0. Columns past K are 0,
// as the reference's -1.0 pad makes them, and 0.0 (and -0.0, NaN) gives
// bit 0. The words are uint32 values held in int64, as everywhere in the
// port.
//
// What bounds it on the H100: bytes. It reads 4 bytes a value and writes 8
// a word; one compare per value is far below any arithmetic limit.
//
// What the design does about it: one thread per value of a padded row of
// 32 * ceil(K/32) slots, so a warp covers exactly one output word: its
// lanes load 32 consecutive values (one coalesced 128-byte line where K is
// a multiple of 32), __ballot_sync packs their signs with bit j from lane
// j, and lane 0 stores the word. Rows need no alignment: a ragged row's
// tail lanes contribute 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void srp_pack_kernel(const float* __restrict__ v,  // (B, K)
                                long long* __restrict__ out,  // (B, W)
                                long long B, int K, int W) {
  const long long slot = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row_slots = (long long)W * 32;
  const long long b = slot / row_slots;
  const int k = (int)(slot - b * row_slots);
  const bool bit = b < B && k < K && v[b * K + k] > 0.f;
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if ((threadIdx.x & 31) == 0 && b < B) out[b * W + (k >> 5)] = (long long)word;
}

}  // namespace

extern "C" int srp_pack_launch(const float* v, long long* out, long long B,
                               int K, void* stream) {
  const int W = (K + 31) / 32;
  const long long slots = B * W * 32;
  const int threads = 256;  // a multiple of 32: warps never straddle words
  srp_pack_kernel<<<(unsigned)((slots + threads - 1) / threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(v, out, B, K, W);
  return (int)cudaGetLastError();
}
