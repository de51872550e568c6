// K1: one launch from a query batch's raw projections to (id, score) top-k,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_query.py::_fused_query_kernel
// (the pl.pallas_call in fused_query) on its single-probe (T = 1),
// dense-window, one-segment branch, with the probe helpers of
// repro/kernels/epilogues.py and the re-rank of
// repro/core/segments.py::hoisted_scores, for CP and TT corpora (the
// template argument TR, the TT rank bound or 0 for CP, picks the format).
// One block serves one query:
//
//   1. discretize the query's L*K raw values (floor((v + b) / w) or v > 0)
//      and radix-combine them into L uint32 bucket keys;
//   2. per table, binary-search sorted_keys[l] (unsigned, side='left') for
//      the bucket start, and a second search bounded by start + cap for its
//      end: the bucket is contiguous in sorted order, so [start, end) is
//      exactly the reference's masked cap-wide window;
//   3. gather perm ids of the window into shared memory, tombstoned slots
//      (live == 0) replaced by the miss sentinel;
//   4. bitonic sort + duplicate mask (the reference's dedup_windows);
//   5. exact re-rank in format: qy and yy from the candidate's CP factor
//      rows or TT core row, qq once per query, combined in the reference's
//      order sqrt(max((qq + yy) - 2 qy, 0)) or qy / (nq * ny);
//   6. the 64-bit selection key (order_key_bits(score) << 32) | eff;
//   7. a second bitonic sort selects the top-k;
//   8. ids, scores and the candidate count are written.
//
// What bounds it on the H100: bytes, and the data decide how many. A query
// reads its L*K values, its own factors, the keys its 2*L binary searches
// touch, the perm/live entries of its windows and one 576-byte CP row (at
// the serving shape) per distinct candidate. At ~120 candidates per query
// that is ~73 MB for a batch of 1024, ~22 us at 3.35 TB/s. The arithmetic
// per candidate (~1.2k FMA) is far below the fp32 rate. A TT candidate is a
// 4 KiB padded row at the TT cell (dims (16, 16, 16, 16), R = 4) and two
// chains of ~10k FMA in all, so there the bytes still bound it at the cell's
// candidate counts.
//
// What the design does about it, and what it does not yet: every
// intermediate (keys, windows, candidates, scores) stays in shared memory;
// HBM sees only the inputs above and the (B, topk) outputs. A warp scores
// one candidate at a time: its lanes copy the candidate's CP row into a
// per-warp shared buffer in one coalesced pass (a few memory transactions
// in flight at once, instead of one dependent L2 round trip per factor
// entry), then each lane takes (r, q) Gram pairs of <Q, Y> and <Y, Y>, and
// a shuffle reduction sums them. A TT row (N, R, d, R) is copied the same
// way; the lanes then own the entries of the <Q, Y> and <Y, Y> chain states
// (R*R each, 32 entries at R = 4) and step both chains mode by mode,
// S'[c][e] = sum_{i,a} Gq[a][i][c] sum_b S[a][b] Gy[b][i][e], with the
// states in a per-warp shared buffer. The binary searches are dependent loads
// and latency-bound; hiding that (several queries per block, prefetching)
// is work for a later change. Shared memory is sized for the worst window
// L*cap (rounded up to a power of two for the bitonic sort): 12 bytes a
// slot, so the largest window one block takes is 16384 slots with CP rows
// of the serving shape and 8192 with 4 KiB TT rows; the wrapper raises
// above it.
//
// Rounding: the score combine uses __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn so no FMA contraction changes the reference's expression, and
// the E2LSH divide is IEEE (__fdiv_rn), never a multiply by 1/w.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPadKey = 0xFFFFFFFFu;
constexpr unsigned long long kPadSlot = 0xFFFFFFFFFFFFFFFFull;

__device__ __forceinline__ float scale_mul(float s, float v) {
  return __fmul_rn(s, v);
}

// prod_n sum_d a[n][d][r] * b[n][d][q]: one (r, q) term of the CP inner
// product of factors stacked (N, D, R*) row-major.
__device__ float pair_term(const float* a, int RA, const float* b, int RB,
                           int N, int D, int r, int q) {
  float prod = 0.f;
  for (int n = 0; n < N; ++n) {
    float dot = 0.f;
    const float* an = a + (size_t)n * D * RA + r;
    const float* bn = b + (size_t)n * D * RB + q;
    for (int d = 0; d < D; ++d) dot += an[d * RA] * bn[d * RB];
    prod = (n == 0) ? dot : prod * dot;
  }
  return prod;
}

// One warp steps up to two TT transfer-matrix chains at once, <A1, B1> and
// <A2, B2> (ra2 = 0 for one chain), over rows in the padded (N, R, D, R)
// layout, ranks at most TR: lanes own entries (c, e) of the ra x rb states,
// kept in st (2 * (ra1*rb1 + ra2*rb2) floats of shared memory: the states
// and their next values). Per mode a lane reads its chain's state into
// registers once, then per slice i issues its TR loads of B and TR of A
// together and does TR*TR + TR FMA:
//   S'[c][e] = sum_i sum_x A[x][i][c] sum_y S[x][y] B[y][i][e].
// Starts from e_00 and returns S[0][0] of each chain to every lane.
template <int TR>
__device__ void tt_chains(const float* a1, int ra1, const float* b1, int rb1,
                          const float* a2, int ra2, const float* b2, int rb2,
                          int N, int D, float* st, int lane, float* v1,
                          float* v2) {
  const int n1 = ra1 * rb1, tot = n1 + ra2 * rb2;
  float* nxt = st + tot;
  for (int p = lane; p < tot; p += 32) st[p] = (p == 0 || p == n1) ? 1.f : 0.f;
  __syncwarp();
  for (int n = 0; n < N; ++n) {
    for (int p = lane; p < tot; p += 32) {
      const bool one = p < n1;
      const int ra = one ? ra1 : ra2, rb = one ? rb1 : rb2;
      const int q = one ? p : p - n1;
      const int c = q / rb, e = q - c * rb;
      const float* s = one ? st : st + n1;
      const float* an = (one ? a1 : a2) + (size_t)n * ra * D * ra + c;
      const float* bn = (one ? b1 : b2) + (size_t)n * rb * D * rb + e;
      float sr[TR][TR];
#pragma unroll
      for (int x = 0; x < TR; ++x)
#pragma unroll
        for (int y = 0; y < TR; ++y)
          sr[x][y] = (x < ra && y < rb) ? s[x * rb + y] : 0.f;
      float acc = 0.f;
      for (int i = 0; i < D; ++i) {
        float bv[TR], av[TR];
#pragma unroll
        for (int y = 0; y < TR; ++y) bv[y] = y < rb ? bn[(y * D + i) * rb] : 0.f;
#pragma unroll
        for (int x = 0; x < TR; ++x) av[x] = x < ra ? an[(x * D + i) * ra] : 0.f;
#pragma unroll
        for (int x = 0; x < TR; ++x) {
          float u = 0.f;
#pragma unroll
          for (int y = 0; y < TR; ++y) u += sr[x][y] * bv[y];
          acc += av[x] * u;
        }
      }
      nxt[p] = acc;
    }
    __syncwarp();
    for (int p = lane; p < tot; p += 32) st[p] = nxt[p];
    __syncwarp();
  }
  *v1 = st[0];
  *v2 = tot > n1 ? st[n1] : 0.f;
  __syncwarp();
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ void bitonic_sort(T* a, int n) {  // n a power of two, ascending
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const T x = a[i], y = a[ixj];
          const bool up = (i & k) == 0;
          if ((x > y) == up) {
            a[i] = y;
            a[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// TR = 0: CP rows; TR = 4 or 8: TT rows of ranks at most TR.
template <int TR>
__global__ void fused_query_kernel(
    const float* __restrict__ values,          // (B, L*K)
    const float* __restrict__ offsets,         // (L*K,)
    const long long* __restrict__ mults,       // (K,)
    const float* __restrict__ q,               // (B, N, D, RQ) or TT (B, N, RQ, D, RQ)
    const float* __restrict__ c,               // (m, N, D, RC) or TT (m, N, RC, D, RC)
    const long long* __restrict__ sorted_keys, // (L, m)
    const int* __restrict__ perm,              // (L, m)
    const unsigned char* __restrict__ live,    // (m + 1,)
    const int* __restrict__ eff,               // (m,)
    int* __restrict__ out_ids, float* __restrict__ out_scores,
    int* __restrict__ out_ncand, int L, int K, int N, int D, int RQ, int RC,
    int m, int cap, int topk, int e2, int euclid, float w, float s_qq,
    float s_qy, float s_yy, int P) {
  constexpr bool tt = TR > 0;
  extern __shared__ unsigned long long smem64[];
  unsigned long long* ckey = smem64;                  // [P]
  uint32_t* win = reinterpret_cast<uint32_t*>(ckey + P);  // [P]
  float* qf = reinterpret_cast<float*>(win + P);      // [FQ]
  const int FQ = tt ? N * RQ * D * RQ : N * D * RQ;  // floats of a query row
  const int FC = tt ? N * RC * D * RC : N * D * RC;  // floats of a corpus row
  const int SW = tt ? 2 * max(RQ * RC + RC * RC, RQ * RQ) : 0;
  const int nwarps = blockDim.x >> 5;
  float* ybuf = qf + FQ;                              // [nwarps][FC]
  float* sbuf = ybuf + nwarps * FC;                   // [nwarps][SW]
  int* starts = reinterpret_cast<int*>(sbuf + nwarps * SW);  // [L]
  int* lens = starts + L;                             // [L]
  int* woff = lens + L;                               // [L + 1]
  __shared__ float qq_s;
  __shared__ int ncand_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < FQ; i += blockDim.x) qf[i] = q[(size_t)b * FQ + i];
  if (tid == 0) ncand_s = 0;

  // 1-2. keys and bucket bounds, one thread per table
  for (int l = tid; l < L; l += blockDim.x) {
    uint32_t key = 0u;
    const float* v = values + (size_t)b * L * K + (size_t)l * K;
    for (int k = 0; k < K; ++k) {
      int code;
      if (e2) {
        code = (int)floorf(__fdiv_rn(__fadd_rn(v[k], offsets[l * K + k]), w));
      } else {
        code = v[k] > 0.f ? 1 : 0;
      }
      key += (uint32_t)code * (uint32_t)mults[k];
    }
    const long long* sk = sorted_keys + (size_t)l * m;
    int lo = 0, hi = m;
    while (lo < hi) {  // first position with sk >= key
      const int mid = (lo + hi) >> 1;
      if ((uint32_t)sk[mid] < key) lo = mid + 1; else hi = mid;
    }
    const int start = lo;
    hi = min(m, start + cap);
    while (lo < hi) {  // first position in the window with sk > key
      const int mid = (lo + hi) >> 1;
      if ((uint32_t)sk[mid] <= key) lo = mid + 1; else hi = mid;
    }
    starts[l] = start;
    lens[l] = lo - start;
  }
  __syncthreads();
  if (warp == 0) {  // qq once per query, the window offsets
    float t = 0.f;
    if constexpr (tt) {
      float unused;
      tt_chains<TR>(qf, RQ, qf, RQ, nullptr, 0, nullptr, 0, N, D, sbuf, lane,
                    &t, &unused);
    } else {
      for (int p = lane; p < RQ * RQ; p += 32)
        t += pair_term(qf, RQ, qf, RQ, N, D, p / RQ, p % RQ);
      t = warp_sum(t);
    }
    if (lane == 0) {
      qq_s = scale_mul(s_qq, t);
      woff[0] = 0;
      for (int l = 0; l < L; ++l) woff[l + 1] = woff[l] + lens[l];
    }
  }
  __syncthreads();

  // 3. window gather: tombstoned slots and the pow2 tail carry sentinels
  const int W = woff[L];
  const int PW = pow2_ceil(W);
  for (int i = tid; i < PW; i += blockDim.x) {
    uint32_t id = kPadKey;
    if (i < W) {
      int l = 0;
      while (woff[l + 1] <= i) ++l;
      const int pos = starts[l] + (i - woff[l]);
      const int cand = perm[(size_t)l * m + pos];
      id = live[cand] ? (uint32_t)cand : (uint32_t)m;
    }
    win[i] = id;
  }
  __syncthreads();

  // 4. sort-dedup, distinct live ids compacted into ckey
  bitonic_sort(win, PW);
  for (int i = tid; i < W; i += blockDim.x) {
    const uint32_t id = win[i];
    if (id < (uint32_t)m && (i == 0 || win[i - 1] != id)) {
      const int slot = atomicAdd(&ncand_s, 1);
      ckey[slot] = id;
    }
  }
  __syncthreads();
  const int n_cand = ncand_s;

  // 5-6. exact re-rank, one warp per candidate, and the selection key
  const float qq = qq_s;
  const int PC = pow2_ceil(n_cand);
  float* yb = ybuf + warp * FC;
  float* sb = sbuf + warp * SW;
  for (int j = warp; j < n_cand; j += nwarps) {
    const uint32_t id = (uint32_t)ckey[j];
    const float* y = c + (size_t)id * FC;
    for (int i = lane; i < FC; i += 32) yb[i] = y[i];
    __syncwarp();
    float tqy = 0.f, tyy = 0.f;
    if constexpr (tt) {
      tt_chains<TR>(qf, RQ, yb, RC, yb, RC, yb, RC, N, D, sb, lane, &tqy,
                    &tyy);
    } else {
      for (int p = lane; p < RQ * RC + RC * RC; p += 32) {
        if (p < RQ * RC) {
          tqy += pair_term(qf, RQ, yb, RC, N, D, p / RC, p % RC);
        } else {
          const int p2 = p - RQ * RC;
          tyy += pair_term(yb, RC, yb, RC, N, D, p2 / RC, p2 % RC);
        }
      }
      tqy = warp_sum(tqy);
      tyy = warp_sum(tyy);
    }
    if (lane == 0) {
      const float qy = scale_mul(s_qy, tqy);
      const float yy = scale_mul(s_yy, tyy);
      float score;
      if (euclid) {
        const float d2 = __fsub_rn(__fadd_rn(qq, yy), __fmul_rn(2.f, qy));
        score = sqrtf(d2 != d2 ? d2 : fmaxf(d2, 0.f));
      } else {
        const float nq = sqrtf(qq != qq ? qq : fmaxf(qq, 0.f));
        const float ny = sqrtf(yy != yy ? yy : fmaxf(yy, 0.f));
        score = __fdiv_rn(qy, __fmul_rn(nq, ny));
      }
      const uint32_t bits = __float_as_uint(euclid ? score : -score);
      const uint32_t key32 = (bits >> 31) ? ~bits : (bits | 0x80000000u);
      ckey[j] = ((unsigned long long)key32 << 32) | (uint32_t)eff[id];
    }
    __syncwarp();
  }
  for (int j = n_cand + tid; j < PC; j += blockDim.x) ckey[j] = kPadSlot;
  __syncthreads();

  // 7-8. top-k
  bitonic_sort(ckey, PC);
  const float bad = __uint_as_float(euclid ? 0x7f800000u : 0xff800000u);
  for (int i = tid; i < topk; i += blockDim.x) {
    int id = -1;
    float score = bad;
    if (i < n_cand) {
      const unsigned long long s = ckey[i];
      const uint32_t key32 = (uint32_t)(s >> 32);
      if (key32 != kPadKey) {
        id = (int)(uint32_t)(s & 0xFFFFFFFFull);
        const uint32_t bits = (key32 >> 31) ? (key32 & 0x7FFFFFFFu) : ~key32;
        const float order = __uint_as_float(bits);
        score = euclid ? order : -order;
      }
    }
    out_ids[(size_t)b * topk + i] = id;
    out_scores[(size_t)b * topk + i] = score;
  }
  if (tid == 0) out_ncand[b] = n_cand;
}

}  // namespace

extern "C" size_t fused_query_smem_bytes(int L, int N, int D, int RQ, int RC,
                                         int P, int threads, int tt) {
  const size_t fq = tt ? (size_t)N * RQ * D * RQ : (size_t)N * D * RQ;
  const size_t fc = tt ? (size_t)N * RC * D * RC : (size_t)N * D * RC;
  const size_t sw = tt ? 2 * (size_t)max(RQ * RC + RC * RC, RQ * RQ) : 0;
  return (size_t)P * 12 + fq * 4 + (size_t)(threads / 32) * (fc + sw) * 4 +
         (size_t)(3 * L + 1) * 4;
}

namespace {

template <int TR>
int launch(const float* values, const float* offsets, const long long* mults,
           const float* q, const float* c, const long long* sorted_keys,
           const int* perm, const unsigned char* live, const int* eff,
           int* out_ids, float* out_scores, int* out_ncand, int B, int L,
           int K, int N, int D, int RQ, int RC, int m, int cap, int topk,
           int e2, int euclid, float w, float s_qq, float s_qy, float s_yy,
           int P, int threads, cudaStream_t stream) {
  const size_t smem =
      fused_query_smem_bytes(L, N, D, RQ, RC, P, threads, TR > 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_query_kernel<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_query_kernel<TR><<<B, threads, smem, stream>>>(
      values, offsets, mults, q, c, sorted_keys, perm, live, eff, out_ids,
      out_scores, out_ncand, L, K, N, D, RQ, RC, m, cap, topk, e2, euclid, w,
      s_qq, s_qy, s_yy, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_query_launch(
    const float* values, const float* offsets, const long long* mults,
    const float* q, const float* c, const long long* sorted_keys,
    const int* perm, const unsigned char* live, const int* eff, int* out_ids,
    float* out_scores, int* out_ncand, int B, int L, int K, int N, int D,
    int RQ, int RC, int m, int cap, int topk, int e2, int euclid, int tt,
    float w, float s_qq, float s_qy, float s_yy, int P, int threads,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tt)
    return launch<0>(values, offsets, mults, q, c, sorted_keys, perm, live,
                     eff, out_ids, out_scores, out_ncand, B, L, K, N, D, RQ,
                     RC, m, cap, topk, e2, euclid, w, s_qq, s_qy, s_yy, P,
                     threads, st);
  if (RQ <= 4 && RC <= 4)
    return launch<4>(values, offsets, mults, q, c, sorted_keys, perm, live,
                     eff, out_ids, out_scores, out_ncand, B, L, K, N, D, RQ,
                     RC, m, cap, topk, e2, euclid, w, s_qq, s_qy, s_yy, P,
                     threads, st);
  if (RQ <= 8 && RC <= 8)
    return launch<8>(values, offsets, mults, q, c, sorted_keys, perm, live,
                     eff, out_ids, out_scores, out_ncand, B, L, K, N, D, RQ,
                     RC, m, cap, topk, e2, euclid, w, s_qq, s_qy, s_yy, P,
                     threads, st);
  return (int)cudaErrorInvalidValue;
}
