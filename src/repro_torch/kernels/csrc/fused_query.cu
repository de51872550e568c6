// K1's same-format instantiations and its C entry points; the kernel is
// fused_query.cuh's fused_query_kernel<TR, QR> (its note says what it
// replaces, what bounds it and what its design does about that), the
// cross-format pairs are instantiated in fused_query_mixed.cu and every
// pair's sampling twin <TR, QR, true> in fused_query_sample.cu, so that nvcc
// builds the three sets side by side.

#include "fused_query.cuh"

namespace {

// Shape<TR, QR>'s values of an instantiation, for the plan checks (all 0
// where none is (tr, qr)).
struct ShapeOf {
  int threads, min_blocks, per_warp, buffers;
  bool tt_pair, one_state, tt_ring;
};

ShapeOf shape_of(int tr, int qr) {
#define K1_SHAPE(TR, QR)                                                \
  if (tr == TR && qr == QR)                                             \
    return {Shape<TR, QR>::threads, Shape<TR, QR>::min_blocks,          \
            Shape<TR, QR>::per_warp, Shape<TR, QR>::buffers,            \
            Shape<TR, QR>::tt_pair, Shape<TR, QR>::one_state,           \
            Shape<TR, QR>::tt_ring};
  K1_SAME_PAIRS(K1_SHAPE)
  K1_MIXED_PAIRS(K1_SHAPE)
#undef K1_SHAPE
  return {0, 0, 0, 0, false, false, false};
}

}  // namespace

// The floats of a row slot of instantiation (tr, qr) for rows of its shape
// (its plan's "ring", see fused_query_smem_bytes), 0 where it keeps none:
// dense rows' ring slots (ring_slot), TT rows' ring slots (tt_ring_slot) and
// <0, 16>'s staged CP rows (whole float4s).
static int row_slot(int tr, int qr, int N, int D, int RC, int row) {
  if (tr == kDense) return ring_slot(row);
  if (shape_of(tr, qr).tt_ring) return tt_ring_slot(N * RC * D * RC);
  if (tr == 0 && qr == 16) return (N * D * RC + 3) & ~3;
  return 0;
}

// Shared memory of one K1 block (fused_query.py's smem_bytes plans with the
// same sum, and fused_query_launch refuses a plan that differs): with ring
// (dense rows of at most kRingRow whole float4s, for queries of any format,
// and TT rows of at most kTTRingRow under Shape::tt_ring) a ring slot a warp
// and its mbarrier (8 bytes), Shape::buffers row buffers a warp for each
// candidate it scores at once (CP rows and TT rows of ranks <= 4; TT rows
// of ranks 5-16, TT rows a cross pair's <16, QR> takes and dense rows go
// through the ring or are read in place; <0, 16> stages its CP rows only
// with ring, else reads them in place), the
// warps' lists and the merged top-k (8 bytes a rank each), the region of
// the hash set and the candidate list (3 * wcap ids) or the expansion's
// per-warp scores and deltas (C of each), the query's row (a dense one, or
// a CP / TT query's densified row over dense rows, only up to kDenseStage
// floats; <0, 16>'s TT query at the wide_row stride), the TT chain scratch
// a warp (<4, 4>'s states; tt_chain's tiles, 2 tt_tile^2 floats a chain,
// and its two slice buffers, 2 tt_tile^2 more: two chains for <8, 8> and
// <16, 16>, one for <16, 0>; none for tt_pair,
// which keeps its states in registers, nor for <16, kDense>; one for the
// block where only the query's own chain needs one: Shape::one_state), four
// per-(table, probe) integer arrays. fmt /
// qfmt: the corpus's / the queries' format, 0 CP, 1 TT, 2 dense; DF the
// dense operand's row of a cross-format pair (prod d). A sampling launch
// (sample) takes 6 words a window slot (the set's ids and counts, the
// list's ids and counts) and a score key (4 bytes) beside each list rank.
extern "C" size_t fused_query_smem_bytes(int LT, int N, int D, int RQ,
                                         int RC, int wcap, int fmt, int qfmt,
                                         int topk, int C, int DF, int ring,
                                         int sample) {
  int tr, qr;
  instance_of(fmt, qfmt, RQ, RC, N, D, &tr, &qr);
  const ShapeOf sh = shape_of(tr, qr);
  if (sh.threads == 0) return 0;
  const bool same = fmt == qfmt;
  const bool tt = fmt == 1, dense = fmt == 2;
  const bool qtt = qfmt == 1, qdense = qfmt == 2;
  const bool wide = tr == 0 && qr == 16;
  const bool tt_ring = sh.tt_ring;
  const bool stage_rows = !dense && tr <= 4 && !wide;
  const size_t nw = sh.threads / 32;
  size_t fq;
  if (same) {
    fq = tt ? (size_t)N * RQ * D * RQ : (size_t)N * D * RQ;
    if (dense && fq > (size_t)kDenseStage) fq = 0;
  } else if (dense || qdense) {
    fq = DF <= kDenseStage ? (size_t)DF : 0;
  } else {
    fq = wide ? (size_t)N * RQ * wide_row(D, RQ)
         : qtt ? (size_t)N * RQ * D * RQ : (size_t)N * D * RQ;
  }
  size_t fc = stage_rows ? (tt ? (size_t)N * RC * D * RC : (size_t)N * D * RC)
              : wide && ring ? (size_t)N * D * RC : 0;
  fc = (fc + 3) & ~(size_t)3;
  const size_t sw =
      same ? (tr == 4 ? 2 * (size_t)max(RQ * RC + RC * RC, RQ * RQ)
              : tt ? 6 * (size_t)tr * tr : 0)
      : sh.tt_pair || (tt_ring && qdense) ? 0
      : wide ? (size_t)RQ * RQ + (size_t)RQ * D * RQ
      : tt ? 4 * (size_t)tt_tile(RC) * tt_tile(RC)
      : qtt ? 2 * (size_t)max(sh.one_state ? 0 : RQ * RC, RQ * RQ) : 0;
  const size_t nsw = sh.one_state ? 1 : nw;
  size_t rw = max((size_t)(sample ? 6 : 3) * wcap, nw * 2 * (size_t)C);
  rw = (rw + 3) & ~(size_t)3;
  const size_t rs = ring && (dense || tt_ring)
                        ? (size_t)row_slot(tr, qr, N, D, RC, same ? D : DF)
                        : 0;
  const size_t slots = rs ? nw * (rs + 2) : 0;
  return (slots + nw * sh.buffers * sh.per_warp * fc + fq + nsw * sw + rw) *
             4 +
         (nw + 1) * topk * (sample ? 12 : 8) +
         (size_t)(4 * LT + 1) * 4;
}

// Registers a thread, resident blocks per SM at smem bytes, local (spill)
// bytes a thread and the instantiation's target blocks per SM -> out[0..3]
// (N, D: the CP / TT operand's, which pick a cross pair's TT instantiation;
// sample: the pair's sampling instantiation).
extern "C" int fused_query_occupancy(int fmt, int qfmt, int RQ, int RC, int N,
                                     int D, int sample, size_t smem,
                                     int* out) {
  int tr, qr;
  instance_of(fmt, qfmt, RQ, RC, N, D, &tr, &qr);
  if (tr < 0 || qr < 0) return (int)cudaErrorInvalidValue;
  if (sample) return fused_query_sample_occupancy(tr, qr, smem, out);
  if (tr != qr) return fused_query_mixed_occupancy(tr, qr, smem, out);
  switch (tr) {
    case 0: return occupancy<0, 0>(smem, out);
    case kDense: return occupancy<kDense, kDense>(smem, out);
    case 4: return occupancy<4, 4>(smem, out);
    case 8: return occupancy<8, 8>(smem, out);
    default: return occupancy<16, 16>(smem, out);
  }
}

extern "C" int fused_query_launch(
    const float* values, const float* offsets, const long long* mults,
    const int* pairs, const float* q, const long long* segtab, int S,
    int* out_ids, float* out_scores, int* out_ncand, int B, int L, int K,
    int T, int C, int N, int D, int RQ, int RC, int topk, int e2, int euclid,
    int fmt, int qfmt, float w, double qs, int wcap, void* scratch, int scap,
    void* scratch_queries, void* qscratch, const int* dims, int DF, int mode,
    unsigned key0, unsigned key1, int threads, int min_blocks, size_t smem,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int tr, qr;
  instance_of(fmt, qfmt, RQ, RC, N, D, &tr, &qr);
  const bool same = fmt == qfmt;
  const bool dense_side = fmt == 2 || qfmt == 2;
  if (tr < 0 || qr < 0 || wcap < 1 || (wcap & (wcap - 1)) || topk < 1 ||
      mode < 0 || mode > 2 || scratch_queries == nullptr ||
      (same && fmt == 2 && (N != 1 || RQ != 1 || RC != 1 ||
                            D > kMaxDenseRow)) ||
      (!same && dense_side &&
       (dims == nullptr || N < 1 || N > kMaxModes || DF > kMaxDenseRow ||
        (fmt == 2 && RC != 1) || (qfmt == 2 && RQ != 1) ||
        (fmt == 2 && DF > kDenseStage && qscratch == nullptr))))
    return (int)cudaErrorInvalidValue;
  // the caller sized the window with its own copy of the block's shape and
  // shared bytes (with the row slots or without them): a launch planned
  // with others is refused
  const int row = same ? D : DF;  // a dense corpus's row
  const int slot = row_slot(tr, qr, N, D, RC, row);
  const int sample = mode != 0;
  const bool ring =
      slot && smem == fused_query_smem_bytes(L * T, N, D, RQ, RC, wcap, fmt,
                                             qfmt, topk, C, DF, 1, sample);
  const ShapeOf sh = shape_of(tr, qr);
  if (threads != sh.threads || min_blocks != sh.min_blocks ||
      (!ring && smem != fused_query_smem_bytes(L * T, N, D, RQ, RC, wcap,
                                               fmt, qfmt, topk, C, DF, 0,
                                               sample)))
    return (int)cudaErrorInvalidConfiguration;
  const K1Args a{values, offsets, mults, pairs, q, segtab, S, out_ids,
                 out_scores, out_ncand, B, L, K, T, C, N, D, RQ, RC, topk,
                 e2, euclid, w, qs, wcap, static_cast<uint32_t*>(scratch),
                 scap, static_cast<unsigned long long*>(scratch_queries),
                 static_cast<float*>(qscratch), dims, DF,
                 ring ? slot : 0, mode, key0, key1};
  if (sample) return fused_query_sample_launch(tr, qr, a, smem, st);
  if (!same) return fused_query_mixed_launch(tr, qr, a, smem, st);
  switch (tr) {
    case 0: return launch<0, 0>(a, smem, st);
    case kDense: return launch<kDense, kDense>(a, smem, st);
    case 4: return launch<4, 4>(a, smem, st);
    case 8: return launch<8, 8>(a, smem, st);
    default: return launch<16, 16>(a, smem, st);
  }
}
