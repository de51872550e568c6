// K1: one launch from a query batch's raw projections to (id, score) top-k
// over every segment of a store, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_query.py::_fused_query_kernel
// (the pl.pallas_call in fused_query), with its multi-probe expansion
// (_expand_probe_keys), the probe helpers of repro/kernels/epilogues.py
// (dense and live windows) and the re-rank of
// repro/core/segments.py::hoisted_scores, for CP and TT corpora (the
// template argument TR, the TT rank bound or 0 for CP, picks the format).
// It also serves K1s, repro/kernels/fused_query.py::fused_query_sharded (the
// same pl.pallas_call over every (shard, segment) pair of a sharded store):
// the wrapper's segment table then holds one row per pair, shard-major,
// each a shard's slice of a base or delta slab with its own m (the shard's
// slot count) and cap. Pad slots of a shard carry the perm entry m and
// live[m] is 0, so a probe that lands on one, even through a pad-key
// collision, is a miss like a tombstone; effective ids are unique across
// shards, so the running top-k over the rows is the reference's S-way
// merge. One block serves one query:
//
//   1. keys, one warp per table: discretize the table's K raw values
//      (floor((v + b) / w) or v > 0) and radix-combine them into the base
//      key; with T > 1 also the expansion: singles ((1 - r)^2, r^2 with
//      deltas +-mults for E2LSH; |v| with the flip's delta for SRP), the
//      pair sums over the static distinct-coordinate pairs (__fadd_rn,
//      uint32 wrap), and T - 1 rounds of a warp argmin that picks the next
//      candidate after the last one in (score, index) order: a stable
//      ascending top-(T-1), ties to the lower index. Slot 0 is the base key
//      and slots past the C candidates repeat it;
//   2. per segment (the segment table's rows, in slot-offset order), per
//      (table, probe): a side='left' binary search for the bucket start,
//      then for the dense window a second search bounded by start + cap
//      (the bucket is contiguous in sorted order, so [start, end) is the
//      reference's masked cap-wide window), or for the live window a
//      side='right' search over the whole table and the live ranks
//      rank0 = live_rank[start], min(cap, live_rank[end] - rank0) slots;
//   3. window gather into shared memory: perm ids of the dense window with
//      tombstoned slots (live == 0) replaced by the miss sentinel, or
//      perm[live_pos[rank0 + j]] (live by construction, no re-check);
//   4. bitonic sort + duplicate mask (dedup_windows: across the T probes of
//      a table too); local ids are per segment, so dedup is per segment and
//      the candidate count is the sum over segments;
//   5. exact re-rank in format: qy and yy from the candidate's CP factor
//      rows or TT core row, qq once per query, combined in the reference's
//      order sqrt(max((qq + yy) - 2 qy, 0)) or qy / (nq * ny);
//   6. the 64-bit selection key (order_key_bits(score) << 32) | eff,
//      bitonic-sorted, and merged into the running top-k: the key is a
//      strict total order on valid slots (effective ids are unique in a
//      store), so the running top-k over the segments equals the
//      reference's one packed_select over their concatenation;
//   7. ids, scores and the candidate count are written.
//
// What bounds it on the H100: bytes, and the data decide how many. A query
// reads its L*K values, its own factors, the keys its binary searches
// touch (2*L*T searches per segment), the perm / live / live_rank /
// live_pos entries of its windows and one corpus row per distinct
// candidate. The expansion's arithmetic (C = 2K^2 candidates a table for
// E2LSH, T - 1 argmin rounds over them) and the re-rank's (~1.2k FMA per
// CP candidate, ~20k per TT candidate at rank 4) are far below the fp32
// rate.
//
// What the design does about it, and what it does not yet: every
// intermediate (keys, windows, candidates, scores, the running top-k)
// stays in shared memory; HBM sees only the inputs above and the
// (B, topk) outputs. A warp scores one candidate at a time: its lanes copy
// the candidate's row into a per-warp shared buffer in one coalesced pass,
// then each lane takes (r, q) Gram pairs of <Q, Y> and <Y, Y> (CP) or owns
// entries of the two chain states (TT), and a shuffle reduction sums them.
// The binary searches are dependent loads and latency-bound; hiding that
// (several queries per block, prefetching) is work for a later change.
// Shared memory is sized for the largest single segment's window L*T*cap
// (rounded up to a power of two for the bitonic sort), not for the sum
// over segments, since segments run one after another: 12 bytes a slot,
// so the largest window one block takes is 16384 slots with CP rows of the
// serving shape and 8192 with 4 KiB TT rows; the wrapper raises above it.
// The expansion's per-warp scores and deltas reuse the window region.
//
// Rounding: the score combine uses __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn so no FMA contraction changes the reference's expression, and
// the E2LSH divide is IEEE (__fdiv_rn), never a multiply by 1/w; the
// expansion's squares and sums are __fmul_rn / __fadd_rn as in JAX.

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


// One row of the (S, 12) int64 segment table (fused_query.py's
// segment_table).
struct Seg {
  const long long* sorted_keys;  // (L, m)
  const int* perm;               // (L, m)
  const unsigned char* live;     // (m + 1,)
  const int* eff;                // (m,)
  const float* c;                // stacked corpus (m, N, D, RC) / (m, N, RC, D, RC)
  const int* live_rank;          // (L, m + 1), nullptr: dense window
  const int* live_pos;           // (L, m)
  int m, cap, rc;
  double cs;                     // the corpus scale
};

__device__ __forceinline__ Seg load_seg(const long long* row) {
  Seg g;
  g.sorted_keys = reinterpret_cast<const long long*>(row[0]);
  g.perm = reinterpret_cast<const int*>(row[1]);
  g.live = reinterpret_cast<const unsigned char*>(row[2]);
  g.eff = reinterpret_cast<const int*>(row[3]);
  g.c = reinterpret_cast<const float*>(row[4]);
  g.live_rank = reinterpret_cast<const int*>(row[5]);
  g.live_pos = reinterpret_cast<const int*>(row[6]);
  g.m = (int)row[7];
  g.cap = (int)row[8];
  g.rc = (int)row[9];
  g.cs = __longlong_as_double(row[10]);
  return g;
}

__device__ __forceinline__ bool lex_less(float s, int c, float bs, int bc) {
  return s < bs || (s == bs && c < bc);
}

// TR = 0: CP rows; TR = 4 or 8: TT rows of ranks at most TR.
template <int TR>
__global__ void fused_query_kernel(
    const float* __restrict__ values,          // (B, L*K)
    const float* __restrict__ offsets,         // (L*K,)
    const long long* __restrict__ mults,       // (K,)
    const int* __restrict__ pairs,             // (C - singles, 2)
    const float* __restrict__ q,               // (B, N, D, RQ) or TT (B, N, RQ, D, RQ)
    const long long* __restrict__ segtab,      // (S, 12)
    int S, int* __restrict__ out_ids, float* __restrict__ out_scores,
    int* __restrict__ out_ncand, int L, int K, int T, int C, int N, int D,
    int RQ, int RCMAX, int topk, int e2, int euclid, float w, double qs,
    int P) {
  constexpr bool tt = TR > 0;
  constexpr unsigned kFull = 0xffffffffu;
  extern __shared__ unsigned long long smem64[];
  const int nwarps = blockDim.x >> 5;
  const int LT = L * T;
  unsigned long long* top = smem64;                   // [2 * topk]
  unsigned long long* ckey = top + 2 * topk;          // [P]
  uint32_t* win = reinterpret_cast<uint32_t*>(ckey + P);  // [P]
  size_t region = max((size_t)P * 12, (size_t)nwarps * C * 8);
  region = (region + 7) & ~(size_t)7;
  float* qf = reinterpret_cast<float*>(
      reinterpret_cast<char*>(ckey) + region);        // [FQ]
  const int FQ = tt ? N * RQ * D * RQ : N * D * RQ;   // floats of a query row
  const int FCMAX = tt ? N * RCMAX * D * RCMAX : N * D * RCMAX;
  const int SW = tt ? 2 * max(RQ * RCMAX + RCMAX * RCMAX, RQ * RQ) : 0;
  float* ybuf = qf + FQ;                              // [nwarps][FCMAX]
  float* sbuf = ybuf + nwarps * FCMAX;                // [nwarps][SW]
  uint32_t* qkeys = reinterpret_cast<uint32_t*>(sbuf + nwarps * SW);  // [LT]
  int* starts = reinterpret_cast<int*>(qkeys + LT);   // [LT]
  int* lens = starts + LT;                            // [LT]
  int* woff = lens + LT;                              // [LT + 1]
  __shared__ float qq_s;
  __shared__ int ncand_s;
  __shared__ int total_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < FQ; i += blockDim.x) qf[i] = q[(size_t)b * FQ + i];
  for (int i = tid; i < topk; i += blockDim.x) top[i] = kPadSlot;
  if (tid == 0) total_s = 0;

  // 1. keys and the multi-probe expansion, one warp per table; the warp's
  // candidate scores and deltas live in the (not yet used) window region
  const int NS = e2 ? 2 * K : K;
  float* sc = reinterpret_cast<float*>(ckey) + (size_t)warp * 2 * C;
  uint32_t* dl = reinterpret_cast<uint32_t*>(sc + C);
  for (int l = warp; l < L; l += nwarps) {
    const float* v = values + (size_t)b * L * K + (size_t)l * K;
    uint32_t part = 0u;
    for (int k = lane; k < K; k += 32) {
      int code;
      float aux;
      if (e2) {
        const float t = __fdiv_rn(__fadd_rn(v[k], offsets[l * K + k]), w);
        const float f = floorf(t);
        code = (int)f;
        aux = __fsub_rn(t, f);
      } else {
        aux = v[k];
        code = aux > 0.f ? 1 : 0;
      }
      const uint32_t mk = (uint32_t)mults[k];
      part += (uint32_t)code * mk;
      if (T > 1) {
        if (e2) {
          const float up = __fsub_rn(1.f, aux);
          sc[k] = __fmul_rn(up, up);
          dl[k] = mk;
          sc[K + k] = __fmul_rn(aux, aux);
          dl[K + k] = 0u - mk;
        } else {
          sc[k] = fabsf(aux);
          dl[k] = aux > 0.f ? 0u - mk : mk;
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
    const uint32_t base = part;
    if (lane == 0) qkeys[l * T] = base;
    if (T > 1) {
      __syncwarp();
      for (int p = lane; p < C - NS; p += 32) {
        const int pa = pairs[2 * p], pb = pairs[2 * p + 1];
        sc[NS + p] = __fadd_rn(sc[pa], sc[pb]);
        dl[NS + p] = dl[pa] + dl[pb];
      }
      __syncwarp();
      const int n = min(T - 1, C);
      float ps = __uint_as_float(0xff800000u);  // -inf
      int pc = -1;
      for (int t = 1; t <= n; ++t) {  // the next candidate after (ps, pc)
        float bs = __uint_as_float(0x7f800000u);  // +inf
        int bc = 0x7fffffff;
        for (int c = lane; c < C; c += 32) {
          const float s = sc[c];
          if (lex_less(ps, pc, s, c) && lex_less(s, c, bs, bc)) {
            bs = s;
            bc = c;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float os = __shfl_xor_sync(kFull, bs, o);
          const int oc = __shfl_xor_sync(kFull, bc, o);
          if (lex_less(os, oc, bs, bc)) {
            bs = os;
            bc = oc;
          }
        }
        ps = bs;
        pc = bc;
        if (lane == 0) qkeys[l * T + t] = base + dl[bc];
      }
      for (int t = n + 1 + lane; t < T; t += 32) qkeys[l * T + t] = base;
      __syncwarp();
    }
  }
  __syncthreads();
  if (warp == 0) {  // qq once per query
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
    if (lane == 0) qq_s = scale_mul((float)(qs * qs), t);
  }
  __syncthreads();
  const float qq = qq_s;
  float* yb = ybuf + warp * FCMAX;
  float* sb = sbuf + warp * SW;

  for (int si = 0; si < S; ++si) {
    const Seg g = load_seg(segtab + (size_t)si * 12);
    if (g.m == 0) continue;
    const bool has_win = g.live_rank != nullptr;
    const size_t m = (size_t)g.m;

    // 2. bucket bounds, one thread per (table, probe)
    for (int i = tid; i < LT; i += blockDim.x) {
      const int l = i / T;
      const uint32_t key = qkeys[i];
      const long long* sk = g.sorted_keys + (size_t)l * m;
      int lo = 0, hi = g.m;
      while (lo < hi) {  // first position with sk >= key
        const int mid = (lo + hi) >> 1;
        if ((uint32_t)sk[mid] < key) lo = mid + 1; else hi = mid;
      }
      const int start = lo;
      hi = has_win ? g.m : min(g.m, start + g.cap);
      while (lo < hi) {  // first position (in the window) with sk > key
        const int mid = (lo + hi) >> 1;
        if ((uint32_t)sk[mid] <= key) lo = mid + 1; else hi = mid;
      }
      if (has_win) {
        const int* lr = g.live_rank + (size_t)l * (m + 1);
        const int r0 = lr[start];
        starts[i] = r0;
        lens[i] = min(g.cap, lr[lo] - r0);
      } else {
        starts[i] = start;
        lens[i] = lo - start;
      }
    }
    __syncthreads();
    if (tid == 0) {
      woff[0] = 0;
      for (int i = 0; i < LT; ++i) woff[i + 1] = woff[i] + lens[i];
      ncand_s = 0;
    }
    __syncthreads();

    // 3. window gather: tombstoned slots and the pow2 tail carry sentinels
    const int W = woff[LT];
    const int PW = pow2_ceil(W);
    for (int i = tid; i < PW; i += blockDim.x) {
      uint32_t id = kPadKey;
      if (i < W) {
        int lo = 0, hi = LT;  // woff[lo] <= i < woff[hi]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (woff[mid] <= i) lo = mid; else hi = mid;
        }
        const size_t row = (size_t)(lo / T) * m;
        const int off = starts[lo] + (i - woff[lo]);
        if (has_win) {
          id = (uint32_t)g.perm[row + g.live_pos[row + off]];
        } else {
          const int cand = g.perm[row + off];
          id = g.live[cand] ? (uint32_t)cand : (uint32_t)g.m;
        }
      }
      win[i] = id;
    }
    __syncthreads();

    // 4. sort-dedup, distinct live ids compacted into ckey
    bitonic_sort(win, PW);
    for (int i = tid; i < W; i += blockDim.x) {
      const uint32_t id = win[i];
      if (id < (uint32_t)g.m && (i == 0 || win[i - 1] != id)) {
        const int slot = atomicAdd(&ncand_s, 1);
        ckey[slot] = id;
      }
    }
    __syncthreads();
    const int n_cand = ncand_s;

    // 5-6. exact re-rank, one warp per candidate, and the selection key
    const int RC = g.rc;
    const int FC = tt ? N * RC * D * RC : N * D * RC;
    const float s_qy = (float)(qs * g.cs), s_yy = (float)(g.cs * g.cs);
    const int PC = pow2_ceil(n_cand);
    for (int j = warp; j < n_cand; j += nwarps) {
      const uint32_t id = (uint32_t)ckey[j];
      const float* y = g.c + (size_t)id * FC;
      // the row through the read-only path, 8 loads in flight per lane
      // before their stores (a 4 KiB TT row is 32 loads a lane)
      for (int i0 = lane; i0 < FC; i0 += 256) {
        float r[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + 32 * u;
          r[u] = i < FC ? __ldg(y + i) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + 32 * u;
          if (i < FC) yb[i] = r[u];
        }
      }
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
        ckey[j] = ((unsigned long long)key32 << 32) | (uint32_t)g.eff[id];
      }
      __syncwarp();
    }
    for (int j = n_cand + tid; j < PC; j += blockDim.x) ckey[j] = kPadSlot;
    __syncthreads();
    bitonic_sort(ckey, PC);

    // merge the segment's best into the running top-k
    if (tid == 0) {
      unsigned long long* out = top + topk;
      const int nb = min(n_cand, topk);
      int a = 0, c = 0;
      for (int o = 0; o < topk; ++o) {
        const unsigned long long x = a < topk ? top[a] : kPadSlot;
        const unsigned long long y = c < nb ? ckey[c] : kPadSlot;
        if (y < x) {
          out[o] = y;
          ++c;
        } else {
          out[o] = x;
          ++a;
        }
      }
      for (int o = 0; o < topk; ++o) top[o] = out[o];
      total_s += n_cand;
    }
    __syncthreads();
  }

  // 7. ids, scores and the candidate count
  const float bad = __uint_as_float(euclid ? 0x7f800000u : 0xff800000u);
  for (int i = tid; i < topk; i += blockDim.x) {
    int id = -1;
    float score = bad;
    const unsigned long long s = top[i];
    const uint32_t key32 = (uint32_t)(s >> 32);
    if (key32 != kPadKey) {
      id = (int)(uint32_t)(s & 0xFFFFFFFFull);
      const uint32_t bits = (key32 >> 31) ? (key32 & 0x7FFFFFFFu) : ~key32;
      const float order = __uint_as_float(bits);
      score = euclid ? order : -order;
    }
    out_ids[(size_t)b * topk + i] = id;
    out_scores[(size_t)b * topk + i] = score;
  }
  if (tid == 0) out_ncand[b] = total_s;
}

}  // namespace

extern "C" size_t fused_query_smem_bytes(int LT, int N, int D, int RQ,
                                         int RC, int P, int threads, int tt,
                                         int topk, int C) {
  const size_t fq = tt ? (size_t)N * RQ * D * RQ : (size_t)N * D * RQ;
  const size_t fc = tt ? (size_t)N * RC * D * RC : (size_t)N * D * RC;
  const size_t sw = tt ? 2 * (size_t)max(RQ * RC + RC * RC, RQ * RQ) : 0;
  const size_t nwarps = threads / 32;
  size_t region = max((size_t)P * 12, nwarps * C * 8);
  region = (region + 7) & ~(size_t)7;
  return (size_t)16 * topk + region + (fq + nwarps * (fc + sw)) * 4 +
         (size_t)(4 * LT + 1) * 4;
}

namespace {

template <int TR>
int launch(const float* values, const float* offsets, const long long* mults,
           const int* pairs, const float* q, const long long* segtab, int S,
           int* out_ids, float* out_scores, int* out_ncand, int B, int L,
           int K, int T, int C, int N, int D, int RQ, int RC, int topk,
           int e2, int euclid, float w, double qs, int P, int threads,
           cudaStream_t stream) {
  const size_t smem = fused_query_smem_bytes(L * T, N, D, RQ, RC, P, threads,
                                             TR > 0, topk, C);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_query_kernel<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_query_kernel<TR><<<B, threads, smem, stream>>>(
      values, offsets, mults, pairs, q, segtab, S, out_ids, out_scores,
      out_ncand, L, K, T, C, N, D, RQ, RC, topk, e2, euclid, w, qs, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_query_launch(
    const float* values, const float* offsets, const long long* mults,
    const int* pairs, const float* q, const long long* segtab, int S,
    int* out_ids, float* out_scores, int* out_ncand, int B, int L, int K,
    int T, int C, int N, int D, int RQ, int RC, int topk, int e2, int euclid,
    int tt, float w, double qs, int P, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int (*fn)(const float*, const float*, const long long*, const int*,
            const float*, const long long*, int, int*, float*, int*, int,
            int, int, int, int, int, int, int, int, int, int, int, float,
            double, int, int, cudaStream_t);
  if (!tt) {
    fn = launch<0>;
  } else if (RQ <= 4 && RC <= 4) {
    fn = launch<4>;
  } else if (RQ <= 8 && RC <= 8) {
    fn = launch<8>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return fn(values, offsets, mults, pairs, q, segtab, S, out_ids, out_scores,
            out_ncand, B, L, K, T, C, N, D, RQ, RC, topk, e2, euclid, w, qs,
            P, threads, st);
}
