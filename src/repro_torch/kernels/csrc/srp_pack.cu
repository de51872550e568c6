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
// a word; one compare per value is far below any arithmetic limit. So the
// design keeps enough loads in flight to stream HBM and spends few issue
// slots per byte.
//
// What the design does about it:
//  - A planned grid (srp_pack.plan in kernels/srp_pack.py; srp_plan here
//    recomputes it and the launch refuses a plan that differs): kThreads
//    threads a block, kMinBlocks blocks a SM, and each warp walks chunks of
//    the rows in a grid-stride loop. A chunk is `rows` whole rows of about
//    kChunkBytes, or, for rows longer than that, one piece of a row that
//    starts and ends on a word. The rows are one flat stream: no lane waits
//    on a padded slot of a ragged row.
//  - Units: where K % 4 == 0 and the values are 16-byte aligned, a lane
//    reads float4 units (the vector path); otherwise single floats (the
//    scalar path: K % 4 != 0, or a view with a storage offset). Each lane
//    issues kLaneBytes of independent streaming loads (__ldcs) before it
//    uses any: 4 float4 or 16 floats, 64 KB in flight a SM.
//  - Index arithmetic is 32-bit inside a chunk: the row of unit i is
//    i / piece by a multiply-high (FastDiv), no 64-bit division per value.
//  - A word is built in registers: on the vector path each lane turns its
//    float4 into a nibble and three __shfl_down_sync steps OR the (at most
//    8) nibbles of one word into its first lane; on the scalar path one
//    __ballot_sync gives a window's 32 signs and the word's first lane
//    shifts its span out. Every lane reaches every shuffle and ballot with
//    the full mask; lanes past the chunk contribute nothing.
//  - A word's first lane ORs it into the warp's staging row in shared
//    memory (a word of a ragged row may span two 32-unit windows, so two
//    lanes may add to it); at the chunk's end the warp stores the chunk's
//    words, one contiguous range, consecutive lanes on consecutive words.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;       // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;       // resident blocks a SM the grid is sized for
constexpr int kChunkBytes = 8192;   // values a warp chunk of short rows holds
constexpr int kStageWords = 256;    // words a warp chunk may hold
constexpr int kLaneBytes = 64;      // bytes a lane loads before it uses any
constexpr unsigned kFull = 0xffffffffu;

// The launch's plan, as srp_pack.plan computes it.
struct SrpPlan {
  int vector;       // 1: float4 units, 0: float units
  int rows;         // whole rows a chunk holds (1 where rows are cut)
  int pieces;       // pieces a row is cut into (1: rows whole)
  int piece;        // units of a full piece (the row's units if whole)
  long long chunks;
  int blocks;
};

SrpPlan srp_plan(long long B, int K, int sms, int aligned) {
  SrpPlan p{};
  p.vector = K % 4 == 0 && aligned;
  const int V = p.vector ? 4 : 1;
  const int ku = K / V;                       // units a row
  const int words = (K + 31) / 32;
  const int chunk_units = kChunkBytes / (4 * V);
  if (ku > chunk_units) {
    p.rows = 1;
    p.piece = chunk_units;                    // a multiple of a word's units
    p.pieces = (ku + chunk_units - 1) / chunk_units;
    p.chunks = B * p.pieces;
  } else {
    const long long warps = (long long)kMinBlocks * sms * kWarps;
    int rows = chunk_units / ku;
    if (kStageWords / words < rows) rows = kStageWords / words;
    if (B / warps < rows) rows = (int)(B / warps);
    p.rows = rows < 1 ? 1 : rows;
    p.piece = ku;
    p.pieces = 1;
    p.chunks = (B + p.rows - 1) / p.rows;
  }
  const long long fill = (p.chunks + kWarps - 1) / kWarps;
  const long long most = (long long)kMinBlocks * sms;
  p.blocks = (int)(fill < most ? fill : most);
  return p;
}

// n / d for 0 <= n < 2^31 by a multiply-high (Granlund and Montgomery).
struct FastDiv {
  unsigned d, mul, shr;
};

FastDiv fast_div(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1u << l) < d) ++l;                // ceil(log2 d)
    f.mul = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
    f.shr = l - 1;
  }
  return f;
}

__device__ __forceinline__ int div_of(int n, FastDiv f) {
  return f.d == 1u ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shr);
}

struct Args {
  long long B;
  int ku, words, rows, pieces, piece;  // units a row, words a row, the plan
  unsigned chunks;
  FastDiv by_piece;
};

__device__ __forceinline__ unsigned signs(float4 x) {
  return (unsigned)(x.x > 0.f) | (unsigned)(x.y > 0.f) << 1 |
         (unsigned)(x.z > 0.f) << 2 | (unsigned)(x.w > 0.f) << 3;
}

template <int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    srp_pack_kernel(const float* __restrict__ v, long long* __restrict__ out,
                    Args a) {
  using Unit = typename std::conditional<V == 4, float4, float>::type;
  constexpr int U = kLaneBytes / (4 * V);     // units a lane loads a round
  constexpr int kUnitsPerWord = 32 / V;
  constexpr int kLogUnits = V == 4 ? 3 : 5;
  __shared__ unsigned stage[kWarps][kStageWords];
  const int lane = threadIdx.x & 31;
  unsigned* st = stage[threadIdx.x >> 5];
  for (int t = lane; t < kStageWords; t += 32) st[t] = 0u;
  __syncwarp();
  const Unit* units = reinterpret_cast<const Unit*>(v);
  const unsigned stride = gridDim.x * kWarps;
  for (unsigned q = blockIdx.x * kWarps + (threadIdx.x >> 5); q < a.chunks;
       q += stride) {
    // the chunk: rows [b0, b0 + rows) whole, or units [col0, col0 + span)
    // of row b0; its words are one contiguous range from g0
    long long b0;
    int col0, span, nw;
    if (a.pieces == 1) {
      b0 = (long long)q * a.rows;
      const long long left = a.B - b0;
      const int rows = left < a.rows ? (int)left : a.rows;
      col0 = 0;
      span = rows * a.ku;
      nw = rows * a.words;
    } else {
      const unsigned b = q / (unsigned)a.pieces;
      b0 = b;
      col0 = (int)(q - b * (unsigned)a.pieces) * a.piece;
      span = min(a.piece, a.ku - col0);
      nw = (span + kUnitsPerWord - 1) >> kLogUnits;
    }
    const Unit* src = units + b0 * a.ku + col0;
    const long long g0 = b0 * a.words + (col0 >> kLogUnits);
    for (int i0 = 0; i0 < span; i0 += 32 * U) {
      Unit x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 32 * u + lane;
        if (i < span) {
          x[u] = __ldcs(src + i);
        } else if constexpr (V == 4) {
          x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          x[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + 32 * u + lane;
        const bool valid = i < span;
        const int r = div_of(i, a.by_piece);
        const int c = i - r * a.piece;            // unit within the piece
        const int cw = c >> kLogUnits;            // word within the piece
        const int pos = c & (kUnitsPerWord - 1);  // unit within the word
        // the word's units: a full word, or the row's tail
        const int len = min(kUnitsPerWord, a.ku - col0 - (cw << kLogUnits));
        unsigned bits;
        if constexpr (V == 4) {
          bits = valid ? signs(x[u]) << (4 * pos) : 0u;
#pragma unroll
          for (int d = 1; d < kUnitsPerWord; d <<= 1) {
            const unsigned t = __shfl_down_sync(kFull, bits, d);
            if (pos + d < len && lane + d < 32) bits |= t;
          }
        } else {
          const unsigned bal = __ballot_sync(kFull, valid && x[u] > 0.f);
          const int n = min(len - pos, 32 - lane);  // this window's span
          const unsigned mask = n >= 32 ? kFull : (1u << n) - 1u;
          bits = ((bal >> lane) & mask) << pos;
        }
        if (valid && (pos == 0 || lane == 0))
          atomicOr(&st[r * a.words + cw], bits);
      }
    }
    __syncwarp();
    for (int t = lane; t < nw; t += 32) {
      out[g0 + t] = (long long)st[t];
      st[t] = 0u;
    }
    __syncwarp();
  }
}

template <int V>
cudaError_t occupancy_of(int* regs, int* blocks, int* local) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, srp_pack_kernel<V>);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *local = (int)attr.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, srp_pack_kernel<V>, kThreads, 0);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

// The planned launch: refused (cudaErrorInvalidConfiguration) unless the
// caller's plan is this source's for the shape, the card and the pointer.
extern "C" int srp_pack_launch(const float* v, long long* out, long long B,
                               int K, int threads, int blocks, int rows,
                               int pieces, int vector, void* stream) {
  const int sms = sm_count();
  if (B <= 0 || K <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  const int aligned = ((uintptr_t)v & 15u) == 0;
  const SrpPlan p = srp_plan(B, K, sms, aligned);
  if (threads != kThreads || blocks != p.blocks || rows != p.rows ||
      pieces != p.pieces || vector != p.vector || p.chunks >= (1ll << 31))
    return (int)cudaErrorInvalidConfiguration;
  Args a{B, p.vector ? K / 4 : K, (K + 31) / 32, p.rows, p.pieces, p.piece,
         (unsigned)p.chunks, fast_div((unsigned)p.piece)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.vector)
    srp_pack_kernel<4><<<p.blocks, kThreads, 0, st>>>(v, out, a);
  else
    srp_pack_kernel<1><<<p.blocks, kThreads, 0, st>>>(v, out, a);
  return (int)cudaGetLastError();
}

// out: registers a thread, resident blocks a SM, local (spilled) bytes a
// thread of the vector (1) or scalar (0) instance.
extern "C" int srp_pack_occupancy(int vector, int* out) {
  const cudaError_t e = vector ? occupancy_of<4>(&out[0], &out[1], &out[2])
                               : occupancy_of<1>(&out[0], &out[1], &out[2]);
  return (int)e;
}
