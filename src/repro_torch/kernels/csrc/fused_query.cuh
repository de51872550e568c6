// K1: one launch from a query batch's raw projections to (id, score) top-k
// over every segment of a store, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/fused_query.py::_fused_query_kernel
// (the pl.pallas_call in fused_query), with its multi-probe expansion
// (_expand_probe_keys), the probe helpers of repro/kernels/epilogues.py
// (dense and live windows) and the re-rank of
// repro/core/segments.py::hoisted_scores, for CP, TT and dense corpora (the
// template argument TR picks the corpus format: 0 CP, kDense = 1 dense
// rows, else the TT rank bound 4, 8 or 16; QR the query's, in the same code).
// A query batch may come in another format than the corpus's (the
// reference's hoisted_scores re-ranks through contractions.inner, which
// covers every pair); those six cross-format pairs are the instantiations
// with QR != TR, below the same-format description.
// It also serves K1s, repro/kernels/fused_query.py::fused_query_sharded (the
// same pl.pallas_call over every (shard, segment) pair of a sharded store):
// the wrapper's segment table then holds one row per pair, shard-major,
// each a shard's slice of a base or delta slab with its own m (the shard's
// slot count) and cap. Pad slots of a shard carry the perm entry m and
// live[m] is 0, so a probe that lands on one, even through a pad-key
// collision, is a miss like a tombstone; effective ids are unique across
// shards, so the top-k over the rows is the reference's S-way merge. One
// block serves one query (12 warps for CP, dense rows with queries of any
// format, dense queries over CP rows and the TT and CP pair branches, 8 for
// TT and the other pairs: Shape below):
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
//   2. per segment (the segment table's rows, in slot-offset order), one
//      warp per (table, probe): a 33-ary search (each step one key load a
//      lane, a ballot, a shuffle) for the bucket start (side='left'), then
//      for the dense window a second one bounded by start + cap (the bucket
//      is contiguous in sorted order, so [start, end) is the reference's
//      masked cap-wide window), or for the live window a side='right' one
//      over the rest of the table and the live ranks rank0 =
//      live_rank[start], min(cap, live_rank[end] - rank0) slots;
//   3. dedup into a hash set of ids: a thread per window slot reads its id
//      (perm of the dense window, tombstoned slots skipped; perm[live_pos[
//      rank0 + j]] of the live one) and inserts it by atomicCAS with linear
//      probing into a set of 2 * pow2(W) slots, W the slots the query
//      filled in this segment (across the T probes of a table too); each
//      successful insert, a distinct live id, goes onto the candidate list,
//      so its length equals the reference's dedup_windows count; local ids
//      are per segment, so dedup is per segment and the candidate count is
//      the sum over segments;
//   4. exact re-rank in format, warp w taking list entries w, w + warps,
//      ...: qy and yy from the candidate's CP factor rows, TT core row or
//      dense row, qq once per query, combined in the reference's order
//      sqrt(max((qq + yy) - 2 qy, 0)) or qy / (nq * ny), and the 64-bit
//      selection key (order_key_bits(score) << 32) | eff entered into the
//      warp's running top-k (an ascending list in shared memory, entered
//      only below its last key);
//   5. the warps' lists merged by rank (a key's rank is its index in its
//      list plus, by binary search, the keys of the other lists below it):
//      the key is a strict total order on valid slots (effective ids are
//      unique in a store), so the top-k over the warps and segments equals
//      the reference's one packed_select over their concatenation; then
//      ids, scores and the candidate count are written.
//
// The sampling modes ("uniform", "weighted": the reference's
// segmented_sample / _sample_topk) are the SAMPLE instantiations, every
// pair's twin in fused_query_sample.cu / fused_query_sample_mixed.cu: stage
// 3 also counts each distinct id's raw hits, stage 4 enters every scored
// candidate into its warp's list by a sampling key (a Gumbel draw keyed by
// the launch's key words, the query row and the effective id: sample_key32)
// with its score key beside it, and stage 5 keeps the first topk by that
// key and writes them in the top-k path's order. Stages 1, 2 and the
// re-rank's arithmetic are the same code, so a sample's bound is the top-k
// path's; the top-k instantiations compile as before (every sampling line
// is behind if constexpr).
//
// What bounds it on the H100: issue slots and latency, not bytes. A query
// reads its L*K values, its own factors, the keys its searches touch, the
// perm / live / live_rank / live_pos entries of its windows and one corpus
// row per distinct candidate (576 B for the CP cell, 4 KiB padded for the
// TT cell): 69 MB a batch of 1024 on [main], 0.02 ms at HBM's rate. The
// re-rank is the work: per candidate and warp a few hundred instructions
// (CP: each lane one Gram term, 36 FMA and 72 shared loads; TT: each lane
// one entry of a chain state, 16 FMA and 8 shared loads per slice), one
// candidate after another. Measured per stage before this design (clock64
// per block): the re-rank 63% of a block on [main] and 87% on [tt-main]
// (a row's load 1.5k-6.2k cycles, then its score 4.0k-21.7k), the 20-step
// binary searches 18% (35% over [shard]'s 4 segments), the window's two
// bitonic sorts and the serial merge 12%; the worst-case window (12 bytes
// a slot of pow2(L*T*cap)) left room for 1-2 blocks per SM, 1 for TT. And
// a block's time follows its query's candidates, which are skewed (the
// largest of a batch of 1024 has ~10x the mean), so the last blocks of a
// launch set its end.
//
// What the design does about it. Occupancy: the shared window has a fixed
// capacity (wcap slots, 12 bytes each: 8 for the hash set, 4 for the list)
// that the wrapper chooses so that the instantiation's blocks per SM fit
// (Shape, also its __launch_bounds__), not the worst case; a query whose
// pow2(W) exceeds it in a segment uses its own row of a global scratch
// instead (the same code through a generic pointer; the wrapper allocates
// it once per store view with its sets empty and empties it again when a
// launch lays its rows out at another stride, and each segment empties the
// set it used), and the launch counts such queries. Latency: a warp's search
// takes 4 dependent loads instead of 20; each warp stages the next
// candidate's row into the other half of a double buffer with cp.async
// (16-byte copies where the rows allow) and loads its effective id before
// it scores the current one, so a row's round trip overlaps the previous
// candidate's arithmetic. Issue slots: the hash set and the warps' lists
// replace the two sorts and the serial merge; the TT chain steps one
// pointer per row of A and B instead of computing each slice's index
// (71 -> about 40 instructions a slice). Heavy queries: a CP block has 12
// warps, each scoring two candidates at once (two independent FMA chains a
// lane), so a query's candidates spread over 24 chains instead of 8.
//
// TT rows of ranks 5-16 (TR = 8 or 16, TT queries of the same rank bound):
// 8 warps, 2 blocks a SM, a row a warp through a ring slot (rows of at most
// kTTRingRow whole float4s, where the plan fits them beside the query's
// cores and the chain tiles), taken from the shared counter as the dense
// rows are, or else read in place a slice G[:, i, :] at a time, the next
// slice copied into the warp's shared buffers while the current one is
// used; qy and yy by tt_pair_chains, the two chains <Q, Y> and <Y, Y> at
// once on the two half-warps (tt_chain: per mode and slice T_i[x][e] =
// sum_y S[x][y] B[y][i][e] formed once into a shared tile, then added into
// the state held in registers, r^3 d + r^3 d FMA a mode; the tiles' columns
// bounded by the row's rank, so a rank-16 query over rank-8 rows forms no
// columns past 8), qq by the same chain on warp 0. The first design stepped
// tt_chains a row a warp: each of the r lanes (c, e) that use T_i[x][e]
// formed it again (r^4 d FMA a mode), at TR = 16 with its state in shared
// memory and the cores read in place, at TR = 8 with a register tile that
// kept one block a SM: 112k cycles a candidate a warp at rank 8, 1,822k at
// rank 16 over rank-8 rows (chip_stages.py --k1), and qq's rank-16 chain on
// warp 0 40% of that launch. Each entry still takes tt_chains' FMAs in their
// order, so the scores are the first design's bit for bit.
//
// Dense rows (TR = kDense; the naive kinds and the tensorized ones over a
// dense corpus: the reference's hoisted_scores on dense rows, jnp.vdot) are
// long (6,912 bytes at (12, 12, 12), 256 KiB at (16, 16, 16, 16)) and read
// once each, so the work is bytes: about n_cand * prod(d) * 4 a batch. The
// query's row is copied into shared memory once while it holds at most
// kDenseStage floats (else it is read in place). Measured before this
// design (clock64 per query, chip_stages.py --k1): a launch ends when its
// heaviest query does (580 candidates on [dense-main], 10x the mean; its
// block ran the whole 0.28 ms span, streaming 15 GB/s: its warps kept 4 KiB
// each in flight, in bursts), the re-rank 60-71% of a query, the probes
// 14-19%. So a block keeps a whole row in flight a warp: 12 warps, each
// with a ring slot of one row in shared memory (rows of at most kRingRow
// whole float4s, 16-byte aligned; 83 KB at [main]'s 1,728 floats) and an
// mbarrier, take the candidate list's next entry from a shared counter (no
// ragged last round), lane 0 copies the row with one bulk copy
// (cp.async.bulk, the mbarrier counting its bytes), and the warp scores it
// from shared memory, its lane 0 having sent the row a warp takes a round
// later into L2 (cp.async.bulk.prefetch.L2); 12 warps also run the L = 10
// probes in one round, each warp a bucket's two bounds at once, and the
// warps' lists merge by flat ranks. Other rows (a 4-byte multiple,
// unaligned, longer, or no room for the ring beside an expansion) are read
// in place, one candidate a warp, lane-strided, four 16-byte loads a row in
// flight a lane (where prod(d) % 4 == 0 and both rows are 16-byte aligned;
// otherwise four 4-byte loads, as K6's two paths do). Either way a lane sums the same
// units in the same order (the two sums qy and yy in one pass over a row),
// then a warp butterfly, so the scores are the first design's bit for bit.
// Rows of up to kMaxDenseRow floats (Table 1's (16, 16, 16, 16)) are taken;
// the launch refuses longer ones.
//
// Queries of another format (QR != TR: fused_query_mixed.cu instantiates
// them; keys, probes, windows, dedup, selection and the output stage are the
// same code, only the prologue and stage 4 differ). qq is computed in the
// query's format (CP Grams, the TT chain or a dot) once per block, yy in the
// corpus's by the corpus branch's own code, qy across the two:
//   * CP or TT query x dense rows (<kDense, 0>, <kDense, 16>): the block
//     densifies its query once in the prologue (each entry sum_r prod_n
//     A_n[i_n, r]; for a TT query prefix by prefix, densify_tt: a prefix's
//     row vector through the first N - 1 cores once, then its d_N entries,
//     each with the first design's FMAs in their order), into the staged
//     query row while it holds at most kDenseStage floats, else into the
//     query's row of a global scratch, while the last warp forms qq beside
//     the keys (the first design ran a whole chain per entry, 16 x 16
//     predicated FMAs a mode, and the TT chain for qq on warp 0 after them:
//     67% of a [mixed tt x dense] launch's cycles, chip_stages.py --k1);
//     the rows are then scored as the dense instantiation scores them (ring
//     slots, 12 warps), so the scores are the first design's bit for bit;
//   * dense query x CP rows (inner_dense_cp): the reference's order, mode 1
//     first, as a register-tiled product (dense_cp_sweep), two candidates a
//     warp and 12 warps a block (80 registers, none spilled): the query row
//     read as (d_1, P), a lane's columns p, each query entry used for the
//     two rows' four ranks at a time, each column then weighted by
//     prod_{n > 1} A_n[i_n(p), r] through a column table the wrapper builds
//     once per mode shape; yy by each row's Grams on a half-warp. The first
//     design's prefix sweep (a lane a prefix (i_1 .. i_{N-1}), its indices
//     decoded by division, the query read at a stride of d_N) took 26k
//     cycles a candidate a warp; a launch ends with its heaviest query
//     (1,119 candidates on [mixed dense x cp]) either way;
//   * CP or dense queries over TT rows of ranks <= 4 and at most
//     kTTPairRow floats (tt_pair, <4, 0> and <4, kDense>): 12 warps, two rows a warp staged in one buffer (the
//     rows the warp takes next sent into L2 while these land), a row a
//     half-warp, every chain state in registers and passed by shuffles:
//     yy by tt_self_half (mode 1 from r_0 = 1, tt_chains' step with its
//     terms shared out over the half, the last mode's S'[0][0] only); qy
//     of a CP query by cp_tt_half (inner_cp_tt: per mode four d-long sums
//     M[q][x][e] = sum_i A[i][q] G[x][i][e] a lane, then S' = S M over the
//     four x lanes of q); of a dense query by dense_tt_sweep (inner_dense_tt
//     mode 1 first, shaped as dense_cp_sweep: half-lanes on the query
//     row's columns, each query entry a load both halves share, each
//     column weighted by G_2[:, i_2, :] ... G_N[:, i_N, 0] through the
//     column table). qq, the scales and the warp list's last key are read
//     from shared memory at selection, so that the scoring keeps every
//     register (80 at 12 warps, 2 blocks a SM, none spilled). The first
//     design scored one row a warp on 8 warps, a 16-lane chain of
//     dependent shared loads (the state, the core and the factor each
//     slice, three __syncwarp a mode; for a dense query a prefix a lane,
//     decoded by division, the query read at a stride of d_N): 28k cycles
//     a candidate a warp, and a launch ended with its heaviest query (837
//     candidates, 10x the mean);
//   * TT queries of ranks <= 4 over CP rows of at most kCPPairRow floats
//     (cp_pair, <0, 4>): cp_tt_half with the roles swapped (inner_cp_tt(row,
//     query)): the staged CP row is the CP operand (its ranks in chunks of
//     four), the query's cores, staged once in qf, the TT one; 12 warps,
//     two rows a warp, a row a half-warp (yy by its Grams on the half), the
//     next pair's rows staged into the warp's second buffer while these are
//     scored; qq by the last warp beside the keys. The first design (<0,
//     16>) stepped cp_tt_chain a row a warp on 8 warps: 16.7k cycles a
//     candidate a warp, the re-rank 75% of the cycles, and the prologue,
//     where warp 0 ran qq's chain through its rank-16 template, 16%;
//   * TT queries of ranks 5-16, or of ranks <= 4 over CP rows longer than
//     kCPPairRow (<0, 16>, wide): the same loop (12 warps, two rows a warp
//     in two buffers, staged where the plan found room, else read in
//     place), qy by cp_tt_wide: a row a half-warp, lane (q, e) holding
//     S[q][e] for one or two CP ranks, per mode the 2E independent d-long
//     sums m[q][x] = sum_i A[i][q] G[x][i][e] over the query's cores staged
//     at an odd row stride (wide_row), then S'[q][e] = sum_x S[q][x]
//     m[q][x] by shuffles; qq by the whole block after the keys
//     (block_tt_self). The first design stepped cp_tt_chain a row a warp
//     on 8 warps, its state in shared memory: 18.8k cycles a candidate a
//     warp at TT rank 8, and qq's chain on warp 0 was 32% of the cycles;
//   * dense queries over TT rows of ranks 5-16, or of ranks <= 4 longer
//     than kTTPairRow (<16, kDense>, tt_ring): 8 warps, a row a warp
//     through a ring slot (rows of at most kTTRingRow whole float4s, where
//     the plan fits them; else read in place), taken from the shared
//     counter as the dense instantiation takes them; qy and yy by
//     dense_tt_row, mode 1 first: lanes on the query row's columns (d_1 x
//     P), each column's weight G_2[:, i_2, :] ... G_N[:, i_N, 0] at the
//     row's rank, then the row's entries, qy the query against them and
//     yy their squares. The first design (prefixes a lane, decoded by
//     division, 16 x 16 predicated steps over cores read in place, yy by a
//     16-wide chain in shared memory) took 815k cycles a candidate a warp;
//   * CP queries over TT rows of ranks 5-16, or longer than kTTPairRow
//     (<16, 0>): the TT rows' ring slots and shape (a row a warp, 8 warps);
//     yy by the row's own tt_chain on the warp, qy by cp_tt_rows: lane (q,
//     e) holds S[q][e] in a register, takes its row S[q][0, r) by shuffles
//     once a mode, then per slice u = sum_x S[q][x] G[x][i][e] (the G loads
//     its chunk's q lanes share) and S'[q][e] += A[i][q] u, the first
//     design's order, so bit-equal to it. The first design (a row a warp
//     read in place, the state in shared memory, yy by tt_chains) took 416k
//     cycles a candidate a warp, 87% of them yy;
//   * dense queries over TT rows (<16, kDense>) take the same ring slots.
// The others score one candidate a warp (8 warps, 2 blocks a SM). The
// bound is the same bytes as the same-format branches plus the reference's
// operations a candidate: its left-to-right sweeps over the dense operand, sum_k 2 R prod_{j>=k} d_j for dense x CP and
// sum_k 2 r_{k-1} r_k prod_{j>=k} d_j for dense x TT, and about
// 2 N d R^ r^2 for CP x TT.
//
// Rounding: the score combine uses __fadd_rn / __fsub_rn / __fmul_rn /
// __fdiv_rn so no FMA contraction changes the reference's expression, and
// the E2LSH divide is IEEE (__fdiv_rn), never a multiply by 1/w; the
// expansion's squares and sums are __fmul_rn / __fadd_rn as in JAX. Each
// lane scores the same Gram terms or chain entries with the same FMAs in
// the same order as before this design, so the scores, and with them every
// output, are unchanged bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Stage stamps, empty here: chip_stages.py defines them in its copy of the
// sources to time each query's stages with clock64().
#ifndef K1_STAMP
#define K1_STAMP_BEGIN
#define K1_STAMP(stage)
#define K1_STAMP_END(query)
#define K1_PART_BEGIN
#define K1_PART(part)
#endif

// One launch's arguments (fused_query.cu's fused_query_launch takes them
// from Python and passes them on to the instantiation).
struct K1Args {
  const float* values;
  const float* offsets;
  const long long* mults;
  const int* pairs;
  const float* q;
  const long long* segtab;
  int S;
  int* out_ids;
  float* out_scores;
  int* out_ncand;
  int B, L, K, T, C, N, D, RQ, RC, topk, e2, euclid;
  float w;
  double qs;
  int wcap;
  uint32_t* scratch;
  int scap;
  unsigned long long* scratch_queries;
  float* qscratch;
  const int* dims;
  int DF;
  int RS;  // the row slot (floats) the plan keeps (RSLOT), 0: none
  int mode;                // 0 topk, 1 uniform, 2 weighted (sampling)
  uint32_t key0, key1;     // the sampling draw's key words
};

// The cross-format instantiations (QR != TR), in fused_query_mixed.cu:
// -> a CUDA error, cudaErrorInvalidValue for a pair it does not hold.
int fused_query_mixed_launch(int tr, int qr, const K1Args& a, size_t smem,
                             cudaStream_t stream);
int fused_query_mixed_occupancy(int tr, int qr, size_t smem, int* out);
// Every pair's sampling instantiation (a.mode 1 or 2): the same-format ones
// in fused_query_sample.cu, the cross-format ones in
// fused_query_sample_mixed.cu.
int fused_query_sample_launch(int tr, int qr, const K1Args& a, size_t smem,
                              cudaStream_t stream);
int fused_query_sample_occupancy(int tr, int qr, size_t smem, int* out);
int fused_query_sample_mixed_launch(int tr, int qr, const K1Args& a,
                                    size_t smem, cudaStream_t stream);
int fused_query_sample_mixed_occupancy(int tr, int qr, size_t smem, int* out);

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;   // an empty hash slot, a pad key
constexpr unsigned long long kPadSlot = 0xFFFFFFFFFFFFFFFFull;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDense = 1;            // TR of the dense-row instantiation
constexpr int kDenseStage = 8192;    // the longest query row staged (floats)
constexpr int kMaxDenseRow = 65536;  // the longest dense row K1 takes
// the longest dense row a warp's ring slot holds (twelve slots and the
// staged query row beside a 1,024-slot window fit two blocks a SM)
constexpr int kRingRow = 2048;
// the most modes of a cross-format pair with a dense side
constexpr int kMaxModes = 16;
// the longest TT row (floats, N * RC * D * RC) that CP or dense queries over
// TT rows of ranks <= 4 stage (tt_pair): 24 such rows are 96 KiB, which
// leaves room at two blocks a SM for the window, the lists and the query
// row; longer rows go to <16, QR>, which reads them in place
constexpr int kTTPairRow = 1024;
// the longest CP row (floats, N * D * RC) that TT queries of ranks <= 4 over
// CP rows stage (cp_pair, <0, 4>): 48 such rows (12 warps, two rows a warp,
// two buffers) are 48 KiB, which leaves room at two blocks a SM for the
// window, the lists and the query's cores (at most 16 * N * D floats);
// longer rows go to <0, 16>
constexpr int kCPPairRow = 256;
// the longest TT row (floats) dense queries over TT rows of ranks 5-16 (or
// past kTTPairRow, <16, kDense>) copy into a warp's ring slot: a rank-8 row
// of [tt8]'s (12, 12, 12); eight such slots beside the query row and the
// window fit two blocks a SM; longer rows are read in place
constexpr int kTTRingRow = 2304;
// Threads of one query's block, the blocks per SM each instantiation is
// built for (its __launch_bounds__; the wrapper sizes the shared window so
// that they fit) and the candidates a warp scores at once: CP 12 warps, 2
// blocks (at most 85 registers, so none spill), two candidates; TT 8 warps,
// one candidate, rank <= 4 3 blocks (two 4 KiB row buffers a warp), ranks
// 5-16 2 (tt_ring: a ring slot a warp, or rows read in place); dense 12
// warps, 2 blocks, one candidate (a ring slot a warp for rows of at most
// kRingRow floats, else read in place). A cross-format pair (QR != TR): 2
// blocks; 8 warps, two dense rows at once or one CP / TT row; dense queries
// over CP rows 12 warps (80 registers), two CP rows a warp; CP or dense
// queries over TT rows of ranks <= 4 and at most kTTPairRow floats
// (tt_pair) 12 warps, two TT rows a warp staged in one buffer; TT queries
// over CP rows (cp_pair, <0, 4> and <0, 16>) 12 warps, two CP rows a warp
// in two buffers; CP or dense queries over TT rows of ranks 5-16 (tt_ring)
// 8 warps, a ring slot a warp; CP or TT queries over dense rows the dense
// instantiation's
// shape (buffers: the row buffers a warp keeps for each candidate it scores,
// two where the next rows are staged while the current ones are scored;
// one_state: the block keeps one TT chain state, the query's own, and not
// one a warp).
template <int TR, int QR>
struct Shape {
  static constexpr bool same = TR == QR;
  static constexpr bool tt_pair = !same && TR == 4;
  // TT queries over CP rows, two rows a warp: ranks <= 4 (<0, 4>) and
  // ranks 5-16 or longer rows (<0, 16>, wide: cp_tt_wide)
  static constexpr bool cp_pair = TR == 0 && QR > kDense;
  // TT rows of ranks 5-16 (or longer than kTTPairRow under a cross pair)
  // with dense, CP or TT queries (<16, kDense>, <16, 0>, <8, 8>, <16, 16>):
  // rows of at most kTTRingRow floats through a ring slot a warp
  static constexpr bool tt_ring =
      (TR == 8 || TR == 16) && (same || QR == kDense || QR == 0);
  static constexpr bool one_state = !same && QR > kDense &&
                                    (TR == kDense || cp_pair);
  static constexpr int per_warp =
      TR == kDense ? 1
      : same ? (TR == 0 ? 2 : 1)
      : (TR == 0 && QR == kDense) || tt_pair || cp_pair ? 2 : 1;
  static constexpr int threads =
      (same && TR == 0) || TR == kDense || (TR == 0 && QR == kDense) ||
              tt_pair || cp_pair
          ? 384
          : 256;
  static constexpr int min_blocks = same && TR == 4 ? 3 : 2;
  static constexpr int buffers = tt_pair ? 1 : 2;
};

// Every instantiation (TR, QR): the same-format ones, built in
// fused_query.cu, and the cross-format ones (QR != TR), built in
// fused_query_mixed.cu.
#define K1_SAME_PAIRS(X) X(0, 0) X(kDense, kDense) X(4, 4) X(8, 8) X(16, 16)
#define K1_MIXED_PAIRS(X) \
  X(kDense, 0) X(kDense, 16) X(0, kDense) X(4, kDense) X(16, kDense) \
  X(4, 0) X(16, 0) X(0, 4) X(0, 16)

// Floats of a dense instantiation's ring slot for rows of D floats: D where
// the rows are whole float4s of at most kRingRow floats, else 0 (no ring:
// rows read in place).
__host__ __device__ constexpr int ring_slot(int D) {
  return (D & 3) == 0 && D <= kRingRow ? D : 0;
}

// Floats of <16, kDense>'s ring slot for TT rows of FC floats (N * RC * D *
// RC): FC where the rows are whole float4s of at most kTTRingRow floats,
// else 0 (rows read in place).
__host__ __device__ constexpr int tt_ring_slot(int FC) {
  return (FC & 3) == 0 && FC <= kTTRingRow ? FC : 0;
}

__device__ __forceinline__ float scale_mul(float s, float v) {
  return __fmul_rn(s, v);
}

// prod_n sum_d a[k][n][d][r] * b[k][n][d][q] added to t[k], for G pairs of
// CP factors stacked (N, D, R*) row-major at once: the (r, q) terms of G
// inner products, each with the same FMAs in the same order as alone, their
// chains interleaved.
template <int G>
__device__ __forceinline__ void pair_terms(const float* const* a, int RA,
                                           const float* const* b, int RB,
                                           int N, int D, int r, int q,
                                           float* t) {
  float prod[G];
#pragma unroll
  for (int k = 0; k < G; ++k) prod[k] = 0.f;
  for (int n = 0; n < N; ++n) {
    float dot[G];
    const float* an[G];
    const float* bn[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      dot[k] = 0.f;
      an[k] = a[k] + (size_t)n * D * RA + r;
      bn[k] = b[k] + (size_t)n * D * RB + q;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int k = 0; k < G; ++k) dot[k] += an[k][d * RA] * bn[k][d * RB];
#pragma unroll
    for (int k = 0; k < G; ++k) prod[k] = (n == 0) ? dot[k] : prod[k] * dot[k];
  }
#pragma unroll
  for (int k = 0; k < G; ++k) t[k] += prod[k];
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
      float acc = 0.f;
      if constexpr (TR <= 8) {
        float sr[TR][TR];
#pragma unroll
        for (int x = 0; x < TR; ++x)
#pragma unroll
          for (int y = 0; y < TR; ++y)
            sr[x][y] = (x < ra && y < rb) ? s[x * rb + y] : 0.f;
        // one pointer a row of B and of A, stepped by a slice: a load and
        // an add each, no index arithmetic
        const float* bp[TR];
        const float* ap[TR];
#pragma unroll
        for (int y = 0; y < TR; ++y) bp[y] = bn + y * D * rb;
#pragma unroll
        for (int x = 0; x < TR; ++x) ap[x] = an + x * D * ra;
        for (int i = 0; i < D; ++i) {
          float bv[TR], av[TR];
#pragma unroll
          for (int y = 0; y < TR; ++y) {
            bv[y] = y < rb ? *bp[y] : 0.f;
            bp[y] += rb;
          }
#pragma unroll
          for (int x = 0; x < TR; ++x) {
            av[x] = x < ra ? *ap[x] : 0.f;
            ap[x] += ra;
          }
#pragma unroll
          for (int x = 0; x < TR; ++x) {
            float u = 0.f;
#pragma unroll
            for (int y = 0; y < TR; ++y) u += sr[x][y] * bv[y];
            acc += av[x] * u;
          }
        }
      } else {  // a TR x TR state does not fit a lane's registers
        for (int i = 0; i < D; ++i) {
          float bv[TR];
#pragma unroll
          for (int y = 0; y < TR; ++y)
            bv[y] = y < rb ? bn[(y * D + i) * rb] : 0.f;
          for (int x = 0; x < ra; ++x) {
            const float* sx = s + x * rb;
            float u = 0.f;
#pragma unroll
            for (int y = 0; y < TR; ++y) u += (y < rb ? sx[y] : 0.f) * bv[y];
            acc += an[(x * D + i) * ra] * u;
          }
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

// <X, X> of a TT query x (N, R, D, R), its stacked rank R at most QR, by one
// warp (tt_chains from e_00, scale not applied, st: 2 R^2 floats): through
// tt_chains<4> (a register tile) for R <= 4, else tt_chains<QR>. Both do
// the same FMAs on the nonzero terms in the same order, and the padded
// terms add exact zeros (x + 0 * y) to sums that start at +0 and so are
// never -0, which leaves them unchanged: the same value bit for bit.
template <int QR>
__device__ float query_chain(const float* x, int R, int N, int D, float* st,
                             int lane) {
  float t, unused;
  if (QR == 4 || R <= 4)
    tt_chains<4>(x, R, x, R, nullptr, 0, nullptr, 0, N, D, st, lane, &t,
                 &unused);
  else
    tt_chains<QR>(x, R, x, R, nullptr, 0, nullptr, 0, N, D, st, lane, &t,
                  &unused);
  return t;
}

// The 64-bit selection key (order_key_bits(score) << 32) | eff of a
// candidate from its unscaled qy and yy: the scales applied, then the
// reference's score expression, sqrt(max((qq + yy) - 2 qy, 0)) or qy /
// (nq * ny).
__device__ __forceinline__ unsigned long long select_key(
    float qq, float tqy, float tyy, float s_qy, float s_yy, int euclid,
    int eff) {
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
  return ((unsigned long long)key32 << 32) | (uint32_t)eff;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// qy[k] = <q, y_k> and yy[k] = <y_k, y_k> over D floats for G rows y_k at
// once, every lane of the warp returning them: lane i sums units i, i + 32,
// ... (float4 units where vec, else floats) in order, loading four units
// of every row before it uses any, then a butterfly. q may lie in shared
// or global memory; the rows lie in global memory and are read through the
// read-only path (kNc), or, for the query's own norm, may lie in shared
// memory and are read with plain loads.
template <bool kNc, typename T>
__device__ __forceinline__ T load_row(const T* p) {
  if constexpr (kNc) return __ldg(p);
  else return *p;
}

template <int G, bool kNc = true>
__device__ __forceinline__ void dense_dots(const float* q,
                                           const float* const* y, int D,
                                           bool vec, int lane, float* qy,
                                           float* yy) {
  float aq[G], ay[G];
#pragma unroll
  for (int k = 0; k < G; ++k) aq[k] = ay[k] = 0.f;
  if (vec) {
    const int n = D >> 2;
    const float4* q4 = reinterpret_cast<const float4*>(q);
    int i = lane;
    for (; i + 96 < n; i += 128) {
      float4 yv[G][4];
#pragma unroll
      for (int k = 0; k < G; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          yv[k][u] = load_row<kNc>(reinterpret_cast<const float4*>(y[k]) +
                                   i + 32 * u);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 a = q4[i + 32 * u];
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const float4 b = yv[k][u];
          aq[k] = fmaf(a.x, b.x, aq[k]);
          aq[k] = fmaf(a.y, b.y, aq[k]);
          aq[k] = fmaf(a.z, b.z, aq[k]);
          aq[k] = fmaf(a.w, b.w, aq[k]);
          ay[k] = fmaf(b.x, b.x, ay[k]);
          ay[k] = fmaf(b.y, b.y, ay[k]);
          ay[k] = fmaf(b.z, b.z, ay[k]);
          ay[k] = fmaf(b.w, b.w, ay[k]);
        }
      }
    }
    for (; i < n; i += 32) {
      const float4 a = q4[i];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const float4 b =
            load_row<kNc>(reinterpret_cast<const float4*>(y[k]) + i);
        aq[k] = fmaf(a.x, b.x, aq[k]);
        aq[k] = fmaf(a.y, b.y, aq[k]);
        aq[k] = fmaf(a.z, b.z, aq[k]);
        aq[k] = fmaf(a.w, b.w, aq[k]);
        ay[k] = fmaf(b.x, b.x, ay[k]);
        ay[k] = fmaf(b.y, b.y, ay[k]);
        ay[k] = fmaf(b.z, b.z, ay[k]);
        ay[k] = fmaf(b.w, b.w, ay[k]);
      }
    }
  } else {
    int i = lane;
    for (; i + 96 < D; i += 128) {
      float yv[G][4];
#pragma unroll
      for (int k = 0; k < G; ++k)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          yv[k][u] = load_row<kNc>(y[k] + i + 32 * u);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float a = q[i + 32 * u];
#pragma unroll
        for (int k = 0; k < G; ++k) {
          aq[k] = fmaf(a, yv[k][u], aq[k]);
          ay[k] = fmaf(yv[k][u], yv[k][u], ay[k]);
        }
      }
    }
    for (; i < D; i += 32) {
      const float a = q[i];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const float b = load_row<kNc>(y[k] + i);
        aq[k] = fmaf(a, b, aq[k]);
        ay[k] = fmaf(b, b, ay[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < G; ++k) {
    qy[k] = warp_sum(aq[k]);
    yy[k] = warp_sum(ay[k]);
  }
}

__device__ __forceinline__ int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The first position p in [lo, hi) with sk[p] > key (upper) or sk[p] >= key
// (not upper), or hi, over the uint32 keys of an ascending int64 array: one
// warp probes 32 positions splitting [lo, hi) into 33 parts, a ballot
// counts those before the bound, and the part that holds it is kept; four
// dependent loads for 2^20 keys instead of a binary search's 20.
__device__ __forceinline__ int warp_bound(const long long* sk, int lo, int hi,
                                          uint32_t key, bool upper,
                                          int lane) {
  while (hi - lo > 32) {
    const long long n = hi - lo;
    const int p = lo + (int)(((long long)(lane + 1) * n) / 33);
    const uint32_t v = (uint32_t)__ldg(sk + p);
    const int c = __popc(__ballot_sync(kFull, upper ? v <= key : v < key));
    const int plo = __shfl_sync(kFull, p, c > 0 ? c - 1 : 0);
    const int phi = __shfl_sync(kFull, p, c < 32 ? c : 31);
    if (c > 0) lo = plo + 1;
    if (c < 32) hi = phi;
  }
  const int p = lo + lane;
  bool before = false;
  if (p < hi) {
    const uint32_t v = (uint32_t)__ldg(sk + p);
    before = upper ? v <= key : v < key;
  }
  return lo + __popc(__ballot_sync(kFull, before));
}

// Both bounds of key over the ascending uint32 keys sk[0, m) at once ->
// *first (the first p with sk[p] >= key) and *past (the first with sk[p] >
// key): warp_bound's steps for the two interleaved, so that their loads are
// in flight together (four dependent loads for 2^20 keys, not 4 + 2).
__device__ __forceinline__ void warp_bounds(const long long* sk, int m,
                                            uint32_t key, int lane,
                                            int* first, int* past) {
  int lo[2] = {0, 0}, hi[2] = {m, m};
  while (hi[0] - lo[0] > 32 || hi[1] - lo[1] > 32) {
    int p[2];
    uint32_t v[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const long long n = hi[s] - lo[s];
      p[s] = lo[s] + (int)(((long long)(lane + 1) * n) / 33);
      v[s] = n > 32 ? (uint32_t)__ldg(sk + p[s]) : 0u;
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (hi[s] - lo[s] <= 32) continue;
      const int c = __popc(__ballot_sync(kFull, s ? v[s] <= key : v[s] < key));
      const int plo = __shfl_sync(kFull, p[s], c > 0 ? c - 1 : 0);
      const int phi = __shfl_sync(kFull, p[s], c < 32 ? c : 31);
      if (c > 0) lo[s] = plo + 1;
      if (c < 32) hi[s] = phi;
    }
  }
  int out[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int q = lo[s] + lane;
    bool before = false;
    if (q < hi[s]) {
      const uint32_t v = (uint32_t)__ldg(sk + q);
      before = s ? v <= key : v < key;
    }
    out[s] = lo[s] + __popc(__ballot_sync(kFull, before));
  }
  *first = out[0];
  *past = out[1];
}

// Inserts id into the open-addressing set ht of 2^(32 - shift) slots ->
// whether it was new.
__device__ __forceinline__ bool set_insert(uint32_t* ht, int shift,
                                           uint32_t id) {
  const uint32_t mask = 0xFFFFFFFFu >> shift;
  uint32_t h = (id * 2654435761u) >> shift;
  while (true) {
    const uint32_t prev = atomicCAS(ht + h, kEmpty, id);
    if (prev == kEmpty) return true;
    if (prev == id) return false;
    h = (h + 1) & mask;
  }
}

// Enters key (the same in every lane) into the warp's ascending list
// wl[0, topk) -> the list's new last key.
__device__ unsigned long long topk_insert(unsigned long long* wl, int topk,
                                          unsigned long long key, int lane) {
  int pos = 0;
  for (int c = 0; c < topk; c += 32) {
    const int i = c + lane;
    pos += __popc(__ballot_sync(kFull, i < topk && wl[i] < key));
  }
  // shift the tail right by one, the last chunk first, reads before writes
  for (int c = (topk - 1) & ~31; c >= 0; c -= 32) {
    const int i = c + lane;
    const unsigned long long prev = i < topk && i > pos ? wl[i - 1] : 0ull;
    __syncwarp();
    if (i < topk && i >= pos) wl[i] = i == pos ? key : prev;
    __syncwarp();
  }
  return wl[topk - 1];
}

// A pair branch's two candidates into the warp's list: t and tyy the qy
// and yy of the half-warps' rows (lanes 0-15 the first, 16-31 the second),
// eff0 / eff1 their effective ids (the second dropped unless two). qq, the
// scales (s[0] s_qy, s[1] s_yy) and the list's last key are read from
// shared memory here rather than held in registers through the scoring.
__device__ __forceinline__ void select_pair(float t, float tyy, int eff0,
                                            int eff1, bool two,
                                            const float& qq, const float* s,
                                            int euclid,
                                            unsigned long long* wl, int topk,
                                            int lane) {
  const float qy[2] = {__shfl_sync(kFull, t, 0), __shfl_sync(kFull, t, 16)};
  const float yy[2] = {__shfl_sync(kFull, tyy, 0),
                       __shfl_sync(kFull, tyy, 16)};
  const int effs[2] = {eff0, eff1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k == 1 && !two) break;
    const unsigned long long key =
        select_key(qq, qy[k], yy[k], s[0], s[1], euclid, effs[k]);
    if (key < wl[topk - 1]) topk_insert(wl, topk, key, lane);
  }
}

// Sampling (the kernel's SAMPLE instantiations, modes "uniform" and
// "weighted"): a query draws topk distinct members of its probed union by
// Gumbel top-k. The noise is a counter-based hash, murmur3's 32-bit
// finalizer over (key words, query row, effective id), so the draw depends
// neither on the order in which the threads fill the candidate list nor on
// the segment or shard that holds a member; fused_query.py's noise_bits and
// sample_key32 compute the same keys in int64 and fp32 for the plain
// version.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// A member's 32-bit sampling key (ascending: drawn first) from its row's
// key (fmix32(key0 ^ fmix32(key1 ^ row))), its effective id and its raw
// hit count: "uniform" (mode 1) ranks by the noise bits h themselves (the
// order of the Gumbel draw g(h), with no rounding); "weighted" by the
// perturbed logit log(cnt) + g, g = -log(-log(u)), u = ((h >> 9) + 0.5)
// 2^-23 (exact in fp32, inside (0, 1)), descending.
__device__ __forceinline__ uint32_t sample_key32(int mode, uint32_t rowkey,
                                                 int eff, uint32_t cnt) {
  const uint32_t h = fmix32(rowkey ^ (uint32_t)eff);
  if (mode == 1) return ~h;
  const float u =
      __uint2float_rn(((h >> 9) << 1) | 1u) * 5.9604644775390625e-8f;
  const float g = -logf(-logf(u));
  const float pert = __fadd_rn(logf(__uint2float_rn(cnt)), g);
  const uint32_t bits = __float_as_uint(-pert);
  return (bits >> 31) ? ~bits : (bits | 0x80000000u);
}

// topk_insert of a sampling key (the same in every lane) with its score
// key (the top-k selection key's upper word) into the warp's list wl and
// its parallel score keys ws -> the list's new last key.
__device__ unsigned long long topk_insert_scored(unsigned long long* wl,
                                                 uint32_t* ws, int topk,
                                                 unsigned long long key,
                                                 uint32_t sk, int lane) {
  int pos = 0;
  for (int c = 0; c < topk; c += 32) {
    const int i = c + lane;
    pos += __popc(__ballot_sync(kFull, i < topk && wl[i] < key));
  }
  for (int c = (topk - 1) & ~31; c >= 0; c -= 32) {
    const int i = c + lane;
    const bool shift = i < topk && i > pos;
    const unsigned long long prev = shift ? wl[i - 1] : 0ull;
    const uint32_t prev_sk = shift ? ws[i - 1] : 0u;
    __syncwarp();
    if (i < topk && i >= pos) {
      wl[i] = i == pos ? key : prev;
      ws[i] = i == pos ? sk : prev_sk;
    }
    __syncwarp();
  }
  return wl[topk - 1];
}

// A scored candidate into a sampling warp's lists: sel its top-k selection
// key ((order_key_bits(score) << 32) | eff), cnt its raw hit count; the
// list is keyed by (sample_key32 << 32) | eff and keeps sel's upper word
// beside it. -> the list's last key (thr if it was not entered).
__device__ __forceinline__ unsigned long long sample_insert(
    unsigned long long* wl, uint32_t* ws, int topk, unsigned long long sel,
    uint32_t cnt, int mode, uint32_t rowkey, unsigned long long thr,
    int lane) {
  const unsigned long long eff = sel & 0xFFFFFFFFull;
  const unsigned long long key =
      ((unsigned long long)sample_key32(mode, rowkey, (int)eff, cnt) << 32) |
      eff;
  if (key < thr)
    return topk_insert_scored(wl, ws, topk, key, (uint32_t)(sel >> 32), lane);
  return thr;
}

// select_pair for a sampling warp: the two candidates' selection keys, each
// entered with its raw hit count (cnt0, cnt1) by sample_insert.
__device__ __forceinline__ void sample_pair(
    float t, float tyy, int eff0, int eff1, uint32_t cnt0, uint32_t cnt1,
    bool two, const float& qq, const float* s, int euclid,
    unsigned long long* wl, uint32_t* ws, int topk, int mode,
    uint32_t rowkey, int lane) {
  const float qy[2] = {__shfl_sync(kFull, t, 0), __shfl_sync(kFull, t, 16)};
  const float yy[2] = {__shfl_sync(kFull, tyy, 0),
                       __shfl_sync(kFull, tyy, 16)};
  const int effs[2] = {eff0, eff1};
  const uint32_t cnts[2] = {cnt0, cnt1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k == 1 && !two) break;
    const unsigned long long sel =
        select_key(qq, qy[k], yy[k], s[0], s[1], euclid, effs[k]);
    sample_insert(wl, ws, topk, sel, cnts[k], mode, rowkey, wl[topk - 1],
                  lane);
  }
}

// Inserts id into a sampling hash set: ht holds 2^(32 - shift) slots of two
// words, the id and its raw hit count, which starts at kEmpty (-1), so that
// a member's count is its word plus one; every insert adds one, whether the
// id was new or found.
__device__ __forceinline__ void set_count(uint32_t* ht, int shift,
                                          uint32_t id) {
  const uint32_t mask = 0xFFFFFFFFu >> shift;
  uint32_t h = (id * 2654435761u) >> shift;
  while (true) {
    const uint32_t prev = atomicCAS(ht + 2 * h, kEmpty, id);
    if (prev == kEmpty || prev == id) {
      atomicAdd(ht + 2 * h + 1, 1u);
      return;
    }
    h = (h + 1) & mask;
  }
}

// The number of keys of the ascending list a[0, n) below x (or at most x:
// the pads, equal keys, of lists merged earlier rank first).
__device__ __forceinline__ int count_below(const unsigned long long* a, int n,
                                           unsigned long long x, bool eq) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x || (eq && a[mid] == x)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
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

// Brings bytes (a multiple of 16, 16-byte aligned) of global memory into
// the L2 cache ahead of their bulk copy, one instruction.
__device__ __forceinline__ void prefetch_l2(const float* src,
                                            unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

// One bulk copy of bytes (a multiple of 16, both ends 16-byte aligned) from
// global into shared memory, completing on bar, whose one arrival announces
// the bytes; the fence orders the slot's earlier reads before the copy.
__device__ __forceinline__ void bulk_row(float* dst, const float* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "{\n"
      ".reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One warp copies a candidate's FC-float row into its shared buffer,
// asynchronously: 16-byte copies where the row and the corpus allow them.
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int FC, bool vec, int lane) {
  if (vec) {
    for (int i = lane; i < (FC >> 2); i += 32)
      cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = lane; i < FC; i += 32) cp_async4(dst + i, src + i);
  }
}

// One row of the (S, 12) int64 segment table (fused_query.py's
// segment_table).
struct Seg {
  const long long* sorted_keys;  // (L, m)
  const int* perm;               // (L, m)
  const unsigned char* live;     // (m + 1,)
  const int* eff;                // (m,)
  // stacked corpus (m, N, D, RC) / (m, N, RC, D, RC) / dense rows (m, D)
  const float* c;
  const int* live_rank;          // (L, m + 1), nullptr: dense window
  const int* live_pos;           // (L, m)
  int m, cap, rc;
  double cs;                     // the corpus scale
  int fc;                        // floats of a stacked corpus row
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
  g.fc = (int)row[11];
  return g;
}

__device__ __forceinline__ bool lex_less(float s, int c, float bs, int bc) {
  return s < bs || (s == bs && c < bc);
}

// A window slot's id: the (table, probe) that holds slot i (woff[lo] <= i <
// woff[lo + 1]), then perm of the dense window (kEmpty where the slot is
// tombstoned or a shard's pad) or perm[live_pos[.]] of the live one (live
// by construction).
__device__ __forceinline__ uint32_t slot_id(const Seg& g, bool has_win,
                                            int T, int LT, const int* woff,
                                            const int* starts, int i) {
  int lo = 0, hi = LT;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (woff[mid] <= i) lo = mid; else hi = mid;
  }
  const size_t row = (size_t)(lo / T) * (size_t)g.m;
  const int off = starts[lo] + (i - woff[lo]);
  if (has_win)
    return (uint32_t)__ldg(g.perm + row + __ldg(g.live_pos + row + off));
  const int cand = __ldg(g.perm + row + off);
  return g.live[cand] ? (uint32_t)cand : kEmpty;
}

// The mode indices of entry p of a dense tensor of modes dims[0, n) (the
// last mode fastest) -> ix[0, n).
__device__ __forceinline__ void unravel(int p, const int* dims, int n,
                                        int* ix) {
  for (int k = n - 1; k >= 0; --k) {
    const int d = __ldg(dims + k);
    ix[k] = p % d;
    p /= d;
  }
}

// v <- v^T G[:, i, :] for a TT core G (R, D, R) row-major, ranks at most B
// (padded rows and columns are zeros).
template <int B>
__device__ __forceinline__ void tt_row_step(float* v, const float* g, int R,
                                            int D, int i) {
  float nv[B];
#pragma unroll
  for (int c = 0; c < B; ++c) nv[c] = 0.f;
#pragma unroll
  for (int a = 0; a < B; ++a) {
    if (a < R) {
      const float* ga = g + ((size_t)a * D + i) * R;
#pragma unroll
      for (int c = 0; c < B; ++c)
        if (c < R) nv[c] = fmaf(v[a], ga[c], nv[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < B; ++c) v[c] = nv[c];
}

// The whole block densifies one CP query row (N, D, R) into out[0, DF),
// scale not applied: each entry sum_r prod_n A_n[i_n, r].
template <int kThreads>
__device__ void densify_cp(const float* x, int R, int N, int D,
                           const int* dims, int DF, float* out, int tid) {
  int ix[kMaxModes];
  for (int p = tid; p < DF; p += kThreads) {
    unravel(p, dims, N, ix);
    float e = 0.f;
    for (int r = 0; r < R; ++r) {
      float prod = x[(size_t)ix[0] * R + r];
      for (int n = 1; n < N; ++n)
        prod *= x[((size_t)n * D + ix[n]) * R + r];
      e += prod;
    }
    out[p] = e;
  }
}

// The whole block densifies one TT query row (N, R, D, R), ranks at most B,
// into out[0, DF), scale not applied, prefix by prefix: thread t takes the
// prefixes p = (i_1 .. i_{N-1}) = t, t + kThreads, ..., forms the chain's
// row vector v = e_0^T G_1[:, i_1, :] ... G_{N-1}[:, i_{N-1}, :] once
// (tt_row_step, loops bounded by the stacked rank R, the cores read from
// global memory), then the last mode's d_N entries v^T G_N[:, j, 0],
// each the FMAs of the chain's last step that reach its component 0, in
// their order. Each entry takes the same FMAs in the same order as a chain
// of its own from e_0 (the first design's), so the row is the same bit for
// bit; a prefix's N - 1 steps are shared by its d_N entries.
template <int B, int kThreads>
__device__ void densify_tt(const float* x, int R, int N, int D,
                           const int* dims, int DF, float* out, int tid) {
  const int dl = __ldg(dims + N - 1);
  const size_t core = (size_t)R * D * R;
  const float* const gl = x + (N - 1) * core;
  int ix[kMaxModes];
  for (int p = tid; p < DF / dl; p += kThreads) {
    unravel(p, dims, N - 1, ix);
    float v[B];
#pragma unroll
    for (int c = 0; c < B; ++c) v[c] = c == 0 ? 1.f : 0.f;
    for (int n = 0; n < N - 1; ++n)
      tt_row_step<B>(v, x + n * core, R, D, ix[n]);
    float* const o = out + (size_t)p * dl;
    for (int j = 0; j < dl; ++j) {
      float e = 0.f;
#pragma unroll
      for (int a = 0; a < B; ++a)
        if (a < R) e = fmaf(v[a], __ldg(gl + ((size_t)a * D + j) * R), e);
      o[j] = e;
    }
  }
}

// Four ranks of one row of a CP factor from p -> v, zeros past the nr
// ranks left: one 16-byte load where the rows are whole float4s (V4: R %
// 4 == 0), else one load a rank.
template <bool V4>
__device__ __forceinline__ void ranks4(float* v, const float* p, int nr) {
  if constexpr (V4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = r < nr ? p[r] : 0.f;
  }
}

// dense_cp_sweep's work for four ranks [r0, r0 + 4) -> acc[k] (below).
template <int G, bool V4>
__device__ __forceinline__ void sweep_ranks(const float* q,
                                            const float* const* a, int R,
                                            int r0, int N, int P, int d1,
                                            const int* ct, int lane,
                                            float* acc) {
  const int nr = R - r0;
  for (int p = lane; p < P; p += 32) {
    float t[G][4];
    const float* ai[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      ai[k] = a[k] + r0;
#pragma unroll
      for (int r = 0; r < 4; ++r) t[k][r] = 0.f;
    }
    const float* qi = q + p;
#pragma unroll 4
    for (int i = 0; i < d1; ++i) {
      const float x = *qi;
      qi += P;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        float av[4];
        ranks4<V4>(av, ai[k], nr);
        ai[k] += R;
#pragma unroll
        for (int r = 0; r < 4; ++r) t[k][r] = fmaf(av[r], x, t[k][r]);
      }
    }
    float w[G][4];
#pragma unroll
    for (int k = 0; k < G; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) w[k][r] = 1.f;
    const int* cn = ct + p;
    for (int n = 1; n < N; ++n, cn += P) {
      const int row = __ldg(cn) * R + r0;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        float an[4];
        ranks4<V4>(an, a[k] + row, nr);
#pragma unroll
        for (int r = 0; r < 4; ++r) w[k][r] *= an[r];
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[k] = fmaf(t[k][r], w[k][r], acc[k]);
  }
}

// qy[k] = <q, Y_k> over a dense query row q of DF floats and G CP rows
// a[k] (N, D, R) staged in shared memory (inner_dense_cp, scale not
// applied), to every lane, in the reference's order: mode 1 first. The row
// reads as (d_1, P), P = DF / d_1 the columns (i_2 .. i_N); lane l takes
// the columns p = l, l + 32, ...: per chunk of four ranks, t[k][r] =
// sum_i A_1k[i, r] q[i, p], each query entry loaded once for the G x 4
// first-factor columns (A_1's rows are loads every lane shares), then
// acc[k] += sum_r t[k][r] w[k][r] with the column's weight w[k][r] =
// prod_{n > 1} A_nk[i_n(p), r], its rows found through the column table
// (dims + N: (N - 1) x P entries n * D + i_n, the wrapper's, read through
// the read-only cache), so no index is decoded here.
template <int G>
__device__ __forceinline__ void dense_cp_sweep(const float* q,
                                               const float* const* a, int R,
                                               int N, const int* dims,
                                               int DF, int lane, float* qy) {
  const int d1 = __ldg(dims);
  const int P = DF / d1;
  float acc[G];
#pragma unroll
  for (int k = 0; k < G; ++k) acc[k] = 0.f;
  for (int r0 = 0; r0 < R; r0 += 4) {
    if ((R & 3) == 0)
      sweep_ranks<G, true>(q, a, R, r0, N, P, d1, dims + N, lane, acc);
    else
      sweep_ranks<G, false>(q, a, R, r0, N, P, d1, dims + N, lane, acc);
  }
#pragma unroll
  for (int k = 0; k < G; ++k) qy[k] = warp_sum(acc[k]);
}

// The rank bound of tt_chain's lane tiles for TT ranks up to r: 8 or 16.
__host__ __device__ constexpr int tt_tile(int r) { return r <= 8 ? 8 : 16; }

// W consecutive floats p[0, W) -> v, zeros past the first n (all zeros
// where n <= 0): one W-wide load where V (the caller found the rank rows
// whole multiples of 4 floats and 16-byte aligned, so that n is then at
// least W or at most 0), else one load a float.
template <int W, bool V>
__device__ __forceinline__ void load_tile(float* v, const float* p, int n) {
  if constexpr (V && W == 4) {
    const float4 x = n > 0 ? *reinterpret_cast<const float4*>(p)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (V && W == 2) {
    const float2 x =
        n > 0 ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = k < n ? p[k] : 0.f;
  }
}

// v[0, W) -> p[0, W), one W-wide store (p aligned to W floats).
template <int W>
__device__ __forceinline__ void store_tile(float* p, const float* v) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// One TT chain <A, B> (inner_tt_tt's transfer matrices, scale not applied)
// on a group of L lanes (16: a half-warp, 32: the warp), stacked ranks ra
// at most ER and rb at most EC (8 or 16), rows (N, r, D, r). From S = e_00,
// per mode
//   T_i[x][e] = sum_y S[x][y] B[y][i][e],  S'[c][e] = sum_i sum_x A[x][i][c] T_i[x][e].
// tt_chains forms T_i[x][e] in each of the r lanes (c, e) that use it (r^4 d
// FMA a mode); here the group forms T_i once into a shared tile (r^3 d) and
// then adds it into the state (r^3 d). Lane l owns a tile of ER / 4 rows (c
// of the state, x of T) by 4 EC / L columns (e); the state stays in its
// registers through a mode and is stored transposed (S^T, EC x ER floats of
// st) at the mode's end for the next mode's T, which lies beside it (ER x
// EC more). Each entry takes tt_chains' FMAs in its order: y ascending
// inside T from +0, then x inner and i outer into the state from +0; mode 1
// (S = e_00) adds A[0][i][c] B[0][i][e], the terms tt_chains' zero rows
// leave; the last mode forms S'[0][0] alone (per slice the T_i[x][0], then
// one FMA chain over the slices and x in every lane). Padded ranks add exact
// zeros to sums that start at +0, which leaves them unchanged, so the chain
// is tt_chains' bit for bit. ra_all, rb_all: the largest ranks over the
// warp's groups, the loops' bounds (both groups of a warp meet the same
// __syncwarp). STAGE: B is a row in global memory (and A too where a_row:
// A = B), read a slice B[:, i, :] at a time: the warp copies slice k + 1
// into sl (two buffers of EC^2 floats) with cp.async while the groups use
// slice k, every lane of the warp taking part (both groups run this code
// over the same row), so no load in the FMA loops waits on global memory.
// -> S[0][0] to every lane of the group.
template <int ER, int EC, int L, bool V, bool STAGE>
__device__ float tt_chain(const float* a, int ra, bool a_row,
                          const float* b, int rb, int ra_all, int rb_all,
                          int N, int D, float* st, float* sl, int lane) {
  static_assert((ER == 8 || ER == 16) && (EC == 8 || EC == 16) &&
                    (L == 16 || L == 32),
                "tile shapes");
  constexpr int RT = ER / 4, CT = 4 * EC / L, CG = L / 4;
  const int l = lane % L;
  const int x0 = (l / CG) * RT, e0 = (l % CG) * CT;
  float* const St = st;            // S^T [y][x], EC x ER
  float* const Tt = st + ER * EC;  // T_i [x][e], ER x EC
  const int dra = D * ra, drb = D * rb;
  const int na = ra - x0, nb = rb - e0;  // a tile row's / column's ranks
  // where the loops read slice i of mode n, A[:, i, :] and B[:, i, :], and
  // their rank-row strides: the rows themselves, or B's staged copy
  const bool a_staged = STAGE && a_row;
  const int asr = a_staged ? rb : dra, bsr = STAGE ? rb : drb;
  const float* as = a;
  const float* bs = b;
  int k = 0, kn = 0, ki = 0;  // slices taken; the next one to stage
  auto stage = [&]() {  // B's slice (kn, ki) into buffer k + 1 (mod 2)
    if (kn >= N) return;
    const float* const src = b + (size_t)kn * rb * drb + ki * rb;
    float* const dst = sl + ((k + 1) & 1) * EC * EC;
    if constexpr (V) {
      const int q4 = rb >> 2;
      for (int c = lane; c < rb * q4; c += 32) {
        const int y = c / q4, e = (c - y * q4) * 4;
        cp_async16(dst + y * rb + e, src + (size_t)y * drb + e);
      }
    } else {
      for (int c = lane; c < rb * rb; c += 32) {
        const int y = c / rb;
        cp_async4(dst + c, src + (size_t)y * drb + (c - y * rb));
      }
    }
    if (++ki == D) {
      ki = 0;
      ++kn;
    }
  };
  auto slice = [&](int n, int i) {
    if constexpr (STAGE) {
      __syncwarp();  // slice k - 1 is read before slice k + 1 takes its buffer
      stage();
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();
      bs = sl + (k & 1) * EC * EC;
      ++k;
    } else {
      bs = b + (size_t)n * rb * drb + i * rb;
    }
    as = a_staged ? bs : a + (size_t)n * ra * dra + i * ra;
  };
  if constexpr (STAGE) {  // slice (0, 0) into buffer 0
    k = -1;
    stage();
    cp_async_commit();
    k = 0;
  }
  float acc[RT][CT];
#pragma unroll
  for (int c = 0; c < RT; ++c)
#pragma unroll
    for (int e = 0; e < CT; ++e) acc[c][e] = 0.f;
#pragma unroll 2
  for (int i = 0; i < D; ++i) {  // mode 1
    slice(0, i);
    float av[RT], bv[CT];
    load_tile<RT, V>(av, as + x0, na);
    load_tile<CT, V>(bv, bs + e0, nb);
#pragma unroll
    for (int c = 0; c < RT; ++c)
#pragma unroll
      for (int e = 0; e < CT; ++e) acc[c][e] = fmaf(av[c], bv[e], acc[c][e]);
  }
  if (N == 1) return __shfl_sync(kFull, acc[0][0], 0, L);
  for (int n = 1;; ++n) {
#pragma unroll
    for (int e = 0; e < CT; ++e) {
      float col[RT];
#pragma unroll
      for (int c = 0; c < RT; ++c) col[c] = acc[c][e];
      store_tile<RT>(St + (e0 + e) * ER + x0, col);
    }
    __syncwarp();
    if (n == N - 1) {
      float r = 0.f;
      if constexpr (STAGE) {  // a slice at a time, as they land
        for (int i = 0; i < D; ++i) {
          slice(n, i);
          if (l < ER) {
            float t = 0.f;
            if (l < ra)
              for (int y = 0; y < rb; ++y)
                t = fmaf(St[y * ER + l], bs[y * bsr], t);
            Tt[l] = t;
          }
          __syncwarp();
          for (int x = 0; x < ra; ++x) r = fmaf(as[x * asr], Tt[x], r);
        }
        return r;
      }
      // EC slices' T_i[x][0] at a time into Tt ([i - i0][x]), then the chain
      const float* const an = a + (size_t)n * ra * dra;
      const float* const bn = b + (size_t)n * rb * drb;
      for (int i0 = 0; i0 < D; i0 += EC) {
        for (int p = l; p < ER * EC; p += L) {
          const int i = i0 + p / ER, x = p % ER;
          float t = 0.f;
          if (i < D && x < ra)
            for (int y = 0; y < rb; ++y)
              t = fmaf(St[y * ER + x], bn[y * drb + i * rb], t);
          Tt[p] = t;
        }
        __syncwarp();
        const int ie = min(D, i0 + EC);
        for (int i = i0; i < ie; ++i) {
          const float* const ai = an + i * ra;
          const float* const ti = Tt + (i - i0) * ER;
#pragma unroll
          for (int x = 0; x < ER; ++x)
            if (x < ra) r = fmaf(ai[x * dra], ti[x], r);
        }
        __syncwarp();
      }
      return r;
    }
#pragma unroll
    for (int c = 0; c < RT; ++c)
#pragma unroll
      for (int e = 0; e < CT; ++e) acc[c][e] = 0.f;
    for (int i = 0; i < D; ++i) {
      slice(n, i);
      float t[RT][CT];
#pragma unroll
      for (int x = 0; x < RT; ++x)
#pragma unroll
        for (int e = 0; e < CT; ++e) t[x][e] = 0.f;
#pragma unroll 4
      for (int y = 0; y < rb_all; ++y) {
        float sv[RT], bv[CT];
        load_tile<RT, true>(sv, St + y * ER + x0, RT);
        load_tile<CT, V>(bv, bs + y * bsr + e0, y < rb ? nb : 0);
#pragma unroll
        for (int x = 0; x < RT; ++x)
#pragma unroll
          for (int e = 0; e < CT; ++e) t[x][e] = fmaf(sv[x], bv[e], t[x][e]);
      }
#pragma unroll
      for (int x = 0; x < RT; ++x)
        store_tile<CT>(Tt + (x0 + x) * EC + e0, t[x]);
      __syncwarp();
#pragma unroll 4
      for (int x = 0; x < ra_all; ++x) {
        float av[RT], tv[CT];
        load_tile<RT, V>(av, as + x * asr + x0, x < ra ? na : 0);
        load_tile<CT, true>(tv, Tt + x * EC + e0, CT);
#pragma unroll
        for (int c = 0; c < RT; ++c)
#pragma unroll
          for (int e = 0; e < CT; ++e)
            acc[c][e] = fmaf(av[c], tv[e], acc[c][e]);
      }
      __syncwarp();
    }
  }
}

// tt_chain over rows read in place, compiled on its own (not inlined), so
// that its staging does not take registers from the re-rank loop around the
// ring slots' inlined copy.
template <int ER, int EC, int L, bool V>
__device__ __noinline__ float tt_chain_far(const float* a, int ra, bool a_row,
                                           const float* b, int rb,
                                           int ra_all, int rb_all, int N,
                                           int D, float* st, float* sl,
                                           int lane) {
  return tt_chain<ER, EC, L, V, true>(a, ra, a_row, b, rb, ra_all, rb_all, N,
                                      D, st, sl, lane);
}

// <X, X> of a TT row x (stacked rank R at most E) on the warp (tt_chain; st:
// 2E^2 floats, 16-byte aligned; in_place: x lies in global memory, its
// slices staged through sl, 2E^2 floats more), float4 loads where R % 4 ==
// 0 and x is 16-byte aligned.
template <int E>
__device__ __forceinline__ float tt_self(const float* x, int R, int N, int D,
                                         float* st, float* sl, int lane,
                                         bool in_place) {
  const bool v = (R & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (in_place)
    return v ? tt_chain_far<E, E, 32, true>(x, R, true, x, R, R, R, N, D, st,
                                            sl, lane)
             : tt_chain_far<E, E, 32, false>(x, R, true, x, R, R, R, N, D,
                                             st, sl, lane);
  return v ? tt_chain<E, E, 32, true, false>(x, R, true, x, R, R, R, N, D, st,
                                             sl, lane)
           : tt_chain<E, E, 32, false, false>(x, R, true, x, R, R, R, N, D,
                                              st, sl, lane);
}

// tt_pair_chains' two chains at row rank bound EC.
template <int E, int EC, bool V, bool STAGE>
__device__ __forceinline__ float pair_chain(const float* q, int RQ,
                                            const float* y, int RC, int N,
                                            int D, float* st, int lane) {
  const int half = lane >> 4;
  const float* const a = half ? y : q;
  const int ra = half ? RC : RQ, rmax = max(RQ, RC);
  float* const sh = st + half * 2 * E * EC;
  if constexpr (STAGE)
    return tt_chain_far<E, EC, 16, V>(a, ra, half != 0, y, RC, rmax, RC, N,
                                      D, sh, st + 4 * E * E, lane);
  return tt_chain<E, EC, 16, V, false>(a, ra, half != 0, y, RC, rmax, RC, N,
                                       D, sh, st + 4 * E * E, lane);
}

// qy = <Q, Y> and yy = <Y, Y> of a TT query q and a TT row y (stacked ranks
// RQ, RC at most E) on one warp: the half-warps step the two chains at once
// (tt_chain: lanes 0-15 <Q, Y>, 16-31 <Y, Y>, each with its tiles in its
// half of st's first 4E^2 floats; the row's rank bound EC is 8 where RC <=
// 8, so a rank-16 query over rank-8 rows forms no columns past them), the
// row's slices staged through st's last 2E^2 floats when it lies in global
// memory (in_place), -> both to every lane.
template <int E>
__device__ __forceinline__ void tt_pair_chains(const float* q, int RQ,
                                               const float* y, int RC, int N,
                                               int D, float* st, int lane,
                                               bool in_place, float* qy,
                                               float* yy) {
  const bool v = ((RQ | RC) & 3) == 0 &&
                 ((reinterpret_cast<uintptr_t>(q) |
                   reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  float t;
  if (E == 16 && RC <= 8) {
    constexpr int EC = E == 16 ? 8 : E;
    t = in_place ? (v ? pair_chain<E, EC, true, true>(q, RQ, y, RC, N, D, st,
                                                      lane)
                      : pair_chain<E, EC, false, true>(q, RQ, y, RC, N, D,
                                                       st, lane))
                 : (v ? pair_chain<E, EC, true, false>(q, RQ, y, RC, N, D,
                                                       st, lane)
                      : pair_chain<E, EC, false, false>(q, RQ, y, RC, N, D,
                                                        st, lane));
  } else {
    t = in_place ? (v ? pair_chain<E, E, true, true>(q, RQ, y, RC, N, D, st,
                                                     lane)
                      : pair_chain<E, E, false, true>(q, RQ, y, RC, N, D, st,
                                                      lane))
                 : (v ? pair_chain<E, E, true, false>(q, RQ, y, RC, N, D, st,
                                                      lane)
                      : pair_chain<E, E, false, false>(q, RQ, y, RC, N, D, st,
                                                       lane));
  }
  *qy = __shfl_sync(kFull, t, 0);
  *yy = __shfl_sync(kFull, t, 16);
}

// <A, G> of a CP row a (N, D, RA) and a TT row g (N, RG, D, RG), RG at most
// E = 8 or 16 (inner_cp_tt, scales not applied), on the warp, to every lane,
// in the first design's order (a warp stepping the (RA x RG) state through
// shared memory), its state in registers: lane l = E ql + e owns entry (q,
// e) for the CP ranks q = ql, ql + 32 / E, ... (a chunk at a time). Per
// mode the lane takes its row S[q][0, RG) from the lanes (ql, x) by
// shuffles, then per slice u = sum_x S[q][x] G[x][i][e] (an FMA chain from
// +0, the G loads the chunk's q lanes share) and acc += A[i][q] u. Mode 1
// starts from S = ones(RA, 1), where u is G[0][i][e]. -> sum_q S[q][0], q
// ascending, from +0.
template <int E>
__device__ float cp_tt_rows(const float* a, int RA, const float* g, int RG,
                            int N, int D, int lane) {
  constexpr int QN = 32 / E;
  const int ql = lane / E, e = lane - ql * E;
  const int ec = min(e, RG - 1);
  const int dr = D * RG;
  const size_t core = (size_t)RG * dr;
  float total = 0.f;
  for (int q0 = 0; q0 < RA; q0 += QN) {
    const int q = min(q0 + ql, RA - 1);
    float s = 0.f;
#pragma unroll 4
    for (int i = 0; i < D; ++i)
      s = fmaf(a[(size_t)i * RA + q], g[(size_t)i * RG + ec], s);
    if (e >= RG) s = 0.f;
    for (int n = 1; n < N; ++n) {
      float srow[E];
#pragma unroll
      for (int x = 0; x < E; ++x) srow[x] = __shfl_sync(kFull, s, ql * E + x);
      const float* const an = a + (size_t)n * D * RA + q;
      const float* const gn = g + n * core + ec;
      float acc = 0.f;
      for (int i = 0; i < D; ++i) {
        float u = 0.f;
#pragma unroll
        for (int x = 0; x < E; ++x)
          if (x < RG) u = fmaf(srow[x], gn[(size_t)x * dr + i * RG], u);
        acc = fmaf(an[(size_t)i * RA], u, acc);
      }
      s = e < RG ? acc : 0.f;
    }
#pragma unroll
    for (int k = 0; k < QN; ++k) {
      const float v = __shfl_sync(kFull, s, k * E);
      if (q0 + k < RA) total += v;
    }
  }
  return total;
}

// The TT pair branches (CP or dense queries over TT rows of ranks at most 4,
// Shape<4, QR>::tt_pair) score two staged rows a warp, a row a half-warp:
// h = lane & 15 is the half-lane. V4: the rows' rank is 4, so a rank row
// G[a][i][0..3] is one 16-byte load.

// <Y, Y> of a TT row g (N, RC, D, RC), ranks at most 4 (scale not applied),
// on a half-warp, to every lane of the half: half-lane h = 4 a + b owns entry
// (a, b) of the chain state S, in a register, so the state passes by
// shuffles and not through shared memory. Mode 1 (r_0 = 1): S[a][b] = sum_i
// G[0][i][a] G[0][i][b]. A middle mode is tt_chains' step with its terms
// shared out: per slice i, lane (a, b) forms V[a][b] = sum_y S[a][y]
// G[y][i][b] once (tt_chains' lanes each formed all four V[x][e] they use),
// then adds sum_x G[x][i][a] V[x][b], the V[x][b] shuffled from lanes (x, b):
// the same FMAs in the same order as tt_chains. The last mode (r_N = 1)
// forms only S'[0][0] = sum_i sum_x G[x][i][0] V[x][0], lane (a, b) taking
// the terms x = a of the slices i = b, b + 4, ..., and a butterfly adding
// them.
template <bool V4>
__device__ __forceinline__ float tt_self_half(const float* g, int RC, int N,
                                              int D, int h) {
  const int r = V4 ? 4 : RC;
  const int a = h >> 2, b = h & 3;
  const bool own = a < r && b < r;
  const int ac = min(a, r - 1), bc = min(b, r - 1);
  const size_t core = (size_t)r * D * r;
  float s = 0.f;
#pragma unroll 4
  for (int i = 0; i < D; ++i) s = fmaf(g[i * r + ac], g[i * r + bc], s);
  if (!own) s = 0.f;
  if (N == 1) return __shfl_sync(kFull, s, 0, 16);
  for (int n = 1;; ++n) {
    const float* gn = g + n * core;
    float srow[4];  // S[a][0..3]
#pragma unroll
    for (int y = 0; y < 4; ++y) srow[y] = __shfl_sync(kFull, s, 4 * a + y, 16);
    if (n == N - 1) {
      // S'[0][0] = sum_i sum_x G[x][i][0] V[x][0]: lane (a, b) forms
      // V[a][0] = sum_y S[a][y] G[y][i][0] for the slices i = b, b + 4, ...
      // and adds G[a][i][0] V[a][0]; a butterfly over the half adds them
      float acc = 0.f;
      for (int i0 = 0; i0 < D; i0 += 4) {
        const int i = i0 + b;
        if (i < D) {
          float v = 0.f;
#pragma unroll
          for (int y = 0; y < 4; ++y)
            if (y < r) v += srow[y] * gn[((size_t)y * D + i) * r];
          acc += gn[((size_t)ac * D + i) * r] * v;
        }
      }
      if (a >= r) acc = 0.f;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        acc += __shfl_xor_sync(kFull, acc, o, 16);
      return acc;
    }
    const float* pb = gn + bc;  // G[y][i][b] at y * D * r + i * r
    const float* pa = gn + ac;  // G[x][i][a]
    const int dr = D * r;
    float acc = 0.f;
#pragma unroll 2
    for (int i = 0; i < D; ++i, pb += r, pa += r) {
      float v = 0.f;
#pragma unroll
      for (int y = 0; y < 4; ++y)
        if (y < r) v += srow[y] * pb[y * dr];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float vx = __shfl_sync(kFull, v, 4 * x + b, 16);
        if (x < r) acc += pa[x * dr] * vx;
      }
    }
    s = own ? acc : 0.f;
  }
}

// <A, G> of a CP row a (N, D, RA) and a TT row g (N, RC, D, RC), TT ranks at
// most 4 (inner_cp_tt, scales not applied), on a half-warp, to every lane of
// the half. Per chunk of four CP ranks, half-lane h = 4 q + x owns entry
// (q, x) of the (R^ x r) state S, in a register. Per mode it forms
//   M[q][x][e] = sum_i A[i][q] G[x][i][e],  e < 4,
// four independent d-long sums over G's rank rows, then S'[q][e] = sum_x
// S[q][x] M[q][x][e] by a butterfly over the four x lanes of q, keeping
// entry e = x: no division, no state in shared memory. Mode 1 starts from
// S = e_0, so there the x lanes split the slices of M[q][0][e] instead.
// -> sum_q S[q][0].
template <bool V4>
__device__ __forceinline__ float cp_tt_half(const float* a, int RA,
                                            const float* g, int RC, int N,
                                            int D, int h) {
  const int r = V4 ? 4 : RC;
  const int ql = h >> 2, x = h & 3;
  const size_t core = (size_t)r * D * r;
  const float* gx = g + (size_t)min(x, r - 1) * D * r;  // G[x][0][0]
  float total = 0.f;
  for (int q0 = 0; q0 < RA; q0 += 4) {
    const float* aq = a + min(q0 + ql, RA - 1);
    float s = 0.f;
    for (int n = 0; n < N; ++n) {
      const float* an = aq + (size_t)n * D * RA;
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      if (n == 0) {
        for (int i0 = 0; i0 < D; i0 += 4) {
          const int i = i0 + x;
          if (i < D) {
            float gv[4];
            ranks4<V4>(gv, g + (size_t)i * r, r);
            const float av = an[(size_t)i * RA];
#pragma unroll
            for (int k = 0; k < 4; ++k) p[k] = fmaf(av, gv[k], p[k]);
          }
        }
      } else {
        const float* gn = gx + n * core;
#pragma unroll 2
        for (int i = 0; i < D; ++i) {
          float gv[4];
          ranks4<V4>(gv, gn + (size_t)i * r, r);
          const float av = an[(size_t)i * RA];
#pragma unroll
          for (int k = 0; k < 4; ++k) p[k] = fmaf(av, gv[k], p[k]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) p[k] *= s;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        p[k] += __shfl_xor_sync(kFull, p[k], 1, 16);
        p[k] += __shfl_xor_sync(kFull, p[k], 2, 16);
      }
      s = x == 0 ? p[0] : x == 1 ? p[1] : x == 2 ? p[2] : p[3];
    }
    if (x == 0 && q0 + ql < RA) total += s;
  }
  total += __shfl_xor_sync(kFull, total, 4, 16);
  total += __shfl_xor_sync(kFull, total, 8, 16);
  return total;
}

// dense_tt_sweep's weight of one column for one TT row g (N, r, D, r): w =
// G_2[:, i_2, :] ... G_N[:, i_N, 0], right to left by r-long sums, the
// slices i_n = ct[(n - 1) * P + p] - n * D from the column table.
template <bool V4>
__device__ __forceinline__ void tt_column_weight(const float* g, int r,
                                                 int N, int D, size_t core,
                                                 const int* ct, int P, int p,
                                                 float* w) {
#pragma unroll
  for (int c = 0; c < 4; ++c) w[c] = c == 0 ? 1.f : 0.f;
  if (N == 1) return;
  const int il = __ldg(ct + (size_t)(N - 2) * P + p) - (N - 1) * D;
  const float* gl = g + (N - 1) * core + (size_t)il * r;
#pragma unroll
  for (int c = 0; c < 4; ++c) w[c] = c < r ? gl[(size_t)c * D * r] : 0.f;
  for (int n = N - 2; n >= 1; --n) {
    const int in = __ldg(ct + (size_t)(n - 1) * P + p) - n * D;
    const float* gn = g + n * core + (size_t)in * r;
    float nv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float ga[4];
      ranks4<V4>(ga, gn + (size_t)min(a, r - 1) * D * r, r);
      float u = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) u = fmaf(ga[c], w[c], u);
      nv[a] = a < r ? u : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) w[a] = nv[a];
  }
}

// The wide branches (TT ranks up to 16: <0, 16>, <16, kDense>) are
// templated on E, a bound of the row's or the query's stacked rank r (4, 8
// or 16; the runtime rank picks the instantiation).

// v[c] = p[c] for c < r, zeros past it: float4 loads where V4 (r % 4 == 0
// and p 16-byte aligned), else one load a rank.
template <int E, bool V4>
__device__ __forceinline__ void load_ranks(float* v, const float* p, int r) {
#pragma unroll
  for (int c4 = 0; c4 < E; c4 += 4) {
    if constexpr (V4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c4 < r) x = *reinterpret_cast<const float4*>(p + c4);
      v[c4] = x.x;
      v[c4 + 1] = x.y;
      v[c4 + 2] = x.z;
      v[c4 + 3] = x.w;
    } else {
#pragma unroll
      for (int c = c4; c < c4 + 4; ++c) v[c] = c < r ? p[c] : 0.f;
    }
  }
}

// The weight of column p of a dense row read as (d_1, P) against a TT row
// g (N, r, D, r), ranks at most E: w = G_2[:, i_2, :] ... G_N[:, i_N, 0],
// right to left by r-long FMA chains, the slices i_n = ct[(n - 1) * P + p]
// - n * D from the column table. tt_column_weight is this at E = 4, kept
// apart: every shared form measured slowed <4, kDense> or <16, kDense>, or
// made <16, kDense> spill (PERF.md, section 7).
template <int E, bool V4>
__device__ __forceinline__ void tt_weight(const float* g, int r, int N, int D,
                                          size_t core, const int* ct, int P,
                                          int p, float* w) {
#pragma unroll
  for (int c = 0; c < E; ++c) w[c] = c == 0 ? 1.f : 0.f;
  if (N == 1) return;
  const size_t dr = (size_t)D * r;
  const int il = __ldg(ct + (size_t)(N - 2) * P + p) - (N - 1) * D;
  const float* gl = g + (N - 1) * core + (size_t)il * r;
#pragma unroll
  for (int c = 0; c < E; ++c) w[c] = c < r ? gl[c * dr] : 0.f;
  for (int n = N - 2; n >= 1; --n) {
    const int in = __ldg(ct + (size_t)(n - 1) * P + p) - n * D;
    const float* gn = g + n * core + (size_t)in * r;
    float nv[E];
#pragma unroll
    for (int a = 0; a < E; ++a) {
      float u = 0.f;
      if (a < r) {
        float ga[E];
        load_ranks<E, V4>(ga, gn + a * dr, r);
#pragma unroll
        for (int c = 0; c < E; ++c) u = fmaf(ga[c], w[c], u);
      }
      nv[a] = u;
    }
#pragma unroll
    for (int a = 0; a < E; ++a) w[a] = nv[a];
  }
}

// <q, Y> over a dense query row q of DF floats and a TT row g (N, RC, D, RC)
// of ranks at most 4 (inner_dense_tt, scale not applied), on a half-warp,
// to every lane of the half, in the reference's order: mode 1 first. The
// row reads as (d_1, P), P = DF / d_1 the columns (i_2 .. i_N); half-lane h
// takes the columns p = h, h + 16, ...: t[r] = sum_i G_1[0][i][r] q[i, p]
// (G_1's rank rows are loads the half shares, each query entry a load the
// two halves share: the warp's two rows meet the same query), then the
// column's weight w (tt_column_weight) and acc += sum_r t[r] w[r]; a
// butterfly over the half ends it.
template <bool V4>
__device__ __forceinline__ float dense_tt_sweep(const float* q,
                                                const float* g, int RC,
                                                int N, int D,
                                                const int* dims, int DF,
                                                int h) {
  const int r = V4 ? 4 : RC;
  const int d1 = __ldg(dims);
  const int P = DF / d1;
  const int* ct = dims + N;
  const size_t core = (size_t)r * D * r;
  float acc = 0.f;
  for (int c0 = 0; c0 < P; c0 += 16) {
    const int p = c0 + h;
    if (p < P) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      const float* qi = q + p;
#pragma unroll 4
      for (int i = 0; i < d1; ++i, qi += P) {
        float gv[4];
        ranks4<V4>(gv, g + (size_t)i * r, r);
        const float xv = *qi;
#pragma unroll
        for (int c = 0; c < 4; ++c) t[c] = fmaf(gv[c], xv, t[c]);
      }
      float w[4];
      tt_column_weight<V4>(g, r, N, D, core, ct, P, p, w);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc = fmaf(t[c], w[c], acc);
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o, 16);
  return acc;
}

// qy = <q, Y> and yy = <Y, Y> of a dense query row q of DF floats and a TT
// row g (N, r, D, r), ranks at most E (inner_dense_tt, scales not applied),
// on a whole warp, to every lane, mode 1 first: the row reads as (d_1, P),
// P = DF / d_1 the columns (i_2 .. i_N); lane l takes the columns p = l,
// l + 32, ..., two at a time: each column's weight w (tt_weight), then the
// row's entries y[i, p] = sum_c G_1[0][i][c] w[c], each G_1 rank row a load
// the lane's columns share (two at a time, one at rank 16, where two
// columns' weights would not fit the registers), and qy += q[i, p] y, yy +=
// y y; a butterfly ends both. The query is read at consecutive columns (no
// stride, no division), and yy is the sum of the squared entries the sweep
// forms anyway, instead of a chain of its own.
template <int E, bool V4>
__device__ __forceinline__ void dense_tt_row(const float* q, const float* g,
                                             int r, int N, int D,
                                             const int* dims, int DF,
                                             int lane, float* qy, float* yy) {
  constexpr int CG = E == 16 ? 1 : 2;  // columns a lane takes at once
  const int d1 = __ldg(dims);
  const int P = DF / d1;
  const int* ct = dims + N;
  const size_t core = (size_t)r * D * r;
  float aq = 0.f, ay = 0.f;
  for (int p0 = lane; p0 < P; p0 += 32 * CG) {
    bool on[CG];
    float w[CG][E];
#pragma unroll
    for (int k = 0; k < CG; ++k) {
      on[k] = p0 + 32 * k < P;
      tt_weight<E, V4>(g, r, N, D, core, ct, P, on[k] ? p0 + 32 * k : p0,
                       w[k]);
    }
    const float* qi = q + p0;
#pragma unroll 2
    for (int i = 0; i < d1; ++i, qi += P) {
      float gv[E];
      load_ranks<E, V4>(gv, g + (size_t)i * r, r);
#pragma unroll
      for (int k = 0; k < CG; ++k) {
        float y = 0.f;
#pragma unroll
        for (int c = 0; c < E; ++c) y = fmaf(gv[c], w[k][c], y);
        if (on[k]) {
          aq = fmaf(qi[32 * k], y, aq);
          ay = fmaf(y, y, ay);
        }
      }
    }
  }
  *qy = warp_sum(aq);
  *yy = warp_sum(ay);
}

// dense_tt_row at the row's rank bound (4, 8 or 16), float4 rank rows
// where the rank is a multiple of 4 and the row 16-byte aligned.
__device__ __forceinline__ void dense_tt_rows(const float* q, const float* g,
                                              int r, int N, int D,
                                              const int* dims, int DF,
                                              int lane, float* qy,
                                              float* yy) {
  const bool v4 = (r & 3) == 0 &&
                  (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (r <= 4) {
    if (v4) dense_tt_row<4, true>(q, g, r, N, D, dims, DF, lane, qy, yy);
    else dense_tt_row<4, false>(q, g, r, N, D, dims, DF, lane, qy, yy);
  } else if (r <= 8) {
    if (v4) dense_tt_row<8, true>(q, g, r, N, D, dims, DF, lane, qy, yy);
    else dense_tt_row<8, false>(q, g, r, N, D, dims, DF, lane, qy, yy);
  } else {
    if (v4) dense_tt_row<16, true>(q, g, r, N, D, dims, DF, lane, qy, yy);
    else dense_tt_row<16, false>(q, g, r, N, D, dims, DF, lane, qy, yy);
  }
}

// The row stride of a TT query's cores staged by <0, 16> (cp_tt_wide): the
// cores (N, r, D, r) with each rank row G[x] (D * r floats) padded to an
// odd stride, so that the last mode's lanes, one a rank x, read G[x][i][0]
// from distinct banks.
__host__ __device__ constexpr int wide_row(int D, int r) { return (D * r) | 1; }

// <A, G> of a CP row a (N, D, RA) and a TT query g staged at the wide_row
// stride (N, r, D, r), ranks at most E = 8 or 16 (inner_cp_tt, scales not
// applied), on a half-warp, to every lane of the half. Half-lane h = E ql +
// e owns entries (q, e) of the (R^ x r) state S for the CP ranks q = q0 +
// ql and q0 + ql + 2 of a chunk at E = 8 (one rank at E = 16), in
// registers. Mode 1 (r_0 = 1): S[q][e] = sum_i A[i][q] G[0][i][e]. A middle
// mode: per x, m[q][x] = sum_i A[i][q] G[x][i][e], 16 independent d-long
// chains at a time (the ranks x in blocks of eight; the lanes' G loads at
// consecutive e, a load both q's and the other half share), then S'[q][e]
// = sum_x S[q][x] m[q][x], S[q][x] shuffled from lane (ql, x): no state in
// shared memory and no __syncwarp a mode; at most 16 sums live, so the
// branch keeps to 80 registers. The last mode (r_N = 1): lane
// (ql, e) takes the rank x = e, S[q][e] sum_i A[i][q] G[e][i][0], and a
// butterfly over the half adds them -> sum_q S'[q][0].
template <int E>
__device__ __forceinline__ float cp_tt_wide(const float* a, int RA,
                                            const float* g, int r, int N,
                                            int D, int h) {
  static_assert(E == 8 || E == 16, "ranks up to 8, or up to 16");
  constexpr int QN = 16 / E;          // q lanes of the half
  constexpr int K = E == 16 ? 1 : 2;  // CP ranks a lane takes at once
  constexpr int XB = 8;               // ranks x a block of sums takes
  const int ql = h / E, e = h - ql * E;
  const int xs = wide_row(D, r);
  const size_t core = (size_t)r * xs;
  const int ec = min(e, r - 1);
  float total = 0.f;
  for (int q0 = 0; q0 < RA; q0 += K * QN) {
    int qk[K];
    bool live[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      qk[k] = q0 + ql + QN * k;
      live[k] = qk[k] < RA && e < r;
      qk[k] = min(qk[k], RA - 1);
    }
    float s[K];
    {  // mode 1, from S = e_0
      float acc[K] = {};
      const float* g0 = g + ec;
      for (int i = 0; i < D; ++i) {
        const float gv = g0[(size_t)i * r];
#pragma unroll
        for (int k = 0; k < K; ++k)
          acc[k] = fmaf(a[(size_t)i * RA + qk[k]], gv, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] = e < r ? acc[k] : 0.f;
    }
    for (int n = 1; n < N; ++n) {
      const float* an = a + (size_t)n * D * RA;
      const float* gn = g + n * core;
      if (n == N - 1) {
        const float* gx = gn + (size_t)ec * xs;  // G[e][i][0]
        float acc[K] = {};
        for (int i = 0; i < D; ++i) {
          const float gv = gx[(size_t)i * r];
#pragma unroll
          for (int k = 0; k < K; ++k)
            acc[k] = fmaf(an[(size_t)i * RA + qk[k]], gv, acc[k]);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) s[k] = __fmul_rn(s[k], acc[k]);
        break;
      }
      float ns[K] = {};
#pragma unroll
      for (int x0 = 0; x0 < E; x0 += XB) {
        float m[K][XB];
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int x = 0; x < XB; ++x) m[k][x] = 0.f;
        const float* ge = gn + (size_t)x0 * xs + ec;
#pragma unroll 1
        for (int i = 0; i < D; ++i) {
          float av[K];
#pragma unroll
          for (int k = 0; k < K; ++k) av[k] = an[(size_t)i * RA + qk[k]];
#pragma unroll
          for (int x = 0; x < XB; ++x) {
            const float gv =
                x0 + x < r ? ge[(size_t)x * xs + (size_t)i * r] : 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k) m[k][x] = fmaf(av[k], gv, m[k][x]);
          }
        }
#pragma unroll
        for (int x = 0; x < XB; ++x) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const float sx = __shfl_sync(kFull, s[k], ql * E + x0 + x, 16);
            ns[k] = fmaf(sx, m[k][x], ns[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] = e < r ? ns[k] : 0.f;
    }
    if (N == 1) {  // sum_q S[q][0]
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] = e == 0 ? s[k] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (live[k]) total += s[k];
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) total += __shfl_xor_sync(kFull, total, o, 16);
  return total;
}

// <G, G> of a TT query g (N, r, D, r) staged at the wide_row stride (scale
// not applied), by the whole block: per mode T[x][i][e] = sum_y S[x][y]
// G[y][i][e], a thread an entry, then S'[c][e] = sum_i sum_x G[x][i][c]
// T[x][i][e], four threads an entry (the slices i = j, j + 4, ... each,
// then a butterfly over the four), both in shared memory (st: r^2 + r D r
// floats), from S = e_00 -> S[0][0] to every thread. Two block barriers a
// mode instead of one warp's chain of 16-wide steps (at rank 8, 140k
// cycles of a [mixed tt8 x cp] prologue that the other warps waited for).
template <int kThreads>
__device__ float block_tt_self(const float* g, int r, int N, int D,
                               float* st, int tid) {
  static_assert(kThreads % 32 == 0, "whole warps take part in the shuffles");
  const int xs = wide_row(D, r), dr = D * r;
  const size_t core = (size_t)r * xs;
  float* const S = st;          // [r][r]
  float* const T = st + r * r;  // [r][D][r]
  for (int p = tid; p < r * r; p += kThreads) S[p] = p == 0 ? 1.f : 0.f;
  __syncthreads();
  for (int n = 0; n < N; ++n) {
    const float* gn = g + n * core;
    for (int p = tid; p < r * dr; p += kThreads) {
      const int x = p / dr, ie = p - x * dr;
      float u = 0.f;
      for (int y = 0; y < r; ++y)
        u = fmaf(S[x * r + y], gn[(size_t)y * xs + ie], u);
      T[p] = u;
    }
    __syncthreads();
    for (int t0 = 0; t0 < 4 * r * r; t0 += kThreads) {
      const int t = t0 + tid, p = t >> 2, j = t & 3;
      float acc = 0.f;
      if (p < r * r) {
        const int c = p / r, e = p - c * r;
        for (int i = j; i < D; i += 4)
          for (int x = 0; x < r; ++x)
            acc = fmaf(gn[(size_t)x * xs + i * r + c], T[x * dr + i * r + e],
                       acc);
      }
      acc += __shfl_xor_sync(kFull, acc, 1);
      acc += __shfl_xor_sync(kFull, acc, 2);
      if (p < r * r && j == 0) S[p] = acc;
    }
    __syncthreads();
  }
  return S[0];
}

// cp_tt_wide at the query's rank bound (8, ranks <= 4 too, or 16).
__device__ __forceinline__ float cp_tt_wides(const float* a, int RA,
                                             const float* g, int r, int N,
                                             int D, int h) {
  if (r <= 8) return cp_tt_wide<8>(a, RA, g, r, N, D, h);
  return cp_tt_wide<16>(a, RA, g, r, N, D, h);
}

// <A, A> of a CP row (N, D, R) by its Grams (scale not applied), to every
// lane: lane p takes the (r, q) terms p, p + 32, ...
__device__ __forceinline__ float cp_self(const float* a, int R, int N, int D,
                                         int lane) {
  const float* aa[1] = {a};
  float t = 0.f;
  for (int p = lane; p < R * R; p += 32)
    pair_terms<1>(aa, R, aa, R, N, D, p / R, p % R, &t);
  return warp_sum(t);
}

// TR = 0: CP rows; TR = kDense: dense rows of D floats (N = RQ = RC = 1);
// TR = 4, 8 or 16: TT rows of ranks at most TR. wcap: the
// shared window's capacity in slots (a power of two; its hash set holds
// 2 * wcap ids, its candidate list wcap); scratch: per query 3 * scap
// uint32 slots of global memory (a hash set of 2 * scap, all empty, and a
// list of scap; scap = pow2(L*T*cap) of the largest cap) for the segments
// whose window exceeds the shared one (nullptr when none can);
// scratch_queries counts the queries that used it. QR: the query's format in
// the same code (QR == TR: the corpus's layout); for a cross-format pair, N
// and D are the CP or TT operand's (its modes and padded mode dim), dims
// the true mode dims (N,), then the dense x CP column table ((N - 1) x
// DF / dims[0]: column_table in fused_query.py), DF their product (the
// dense operand's row),
// and qscratch (B, DF) floats holds the densified CP or TT queries over dense
// rows longer than kDenseStage (nullptr otherwise). RSLOT: the row slot in
// floats the launch's plan keeps, or 0 (rows read in place): the dense
// rows' ring slot (ring_slot), <16, kDense>'s TT rows' (tt_ring_slot),
// <0, 16>'s staged CP row. SAMPLE: the sampling instantiation (mode 1
// uniform, 2 weighted, key0 / key1 the draw's key words; see sample_key32):
// stage 3 counts each distinct id's raw hits (set_count, 6 words a window
// slot: the set's (id, count) slots, then the list's ids and counts, the
// scratch's row at 6 * scap), stage 4 scores every distinct candidate as
// the top-k path does and enters it into its warp's list by its sampling
// key, its score key beside it, and stage 5 merges by the sampling key,
// keeps the first topk and writes them in the top-k path's order.
template <int TR, int QR, bool SAMPLE = false>
__global__ void __launch_bounds__(Shape<TR, QR>::threads,
                                  Shape<TR, QR>::min_blocks)
fused_query_kernel(
    const float* __restrict__ values,          // (B, L*K)
    const float* __restrict__ offsets,         // (L*K,)
    const long long* __restrict__ mults,       // (K,)
    const int* __restrict__ pairs,             // (C - singles, 2)
    const float* __restrict__ q,               // (B, N, D, RQ) or TT (B, N, RQ, D, RQ)
    const long long* __restrict__ segtab,      // (S, 12)
    int S, int* __restrict__ out_ids, float* __restrict__ out_scores,
    int* __restrict__ out_ncand, int L, int K, int T, int C, int N, int D,
    int RQ, int RCMAX, int topk, int e2, int euclid, float w, double qs,
    int wcap, uint32_t* __restrict__ scratch, int scap,
    unsigned long long* __restrict__ scratch_queries,
    float* __restrict__ qscratch, const int* __restrict__ dims, int DF,
    int RSLOT, int mode, uint32_t key0, uint32_t key1) {
  constexpr bool same = TR == QR;
  constexpr bool dense = TR == kDense;
  constexpr bool tt = TR > kDense;
  constexpr bool qdense = QR == kDense, qtt = QR > kDense;
  // a CP or TT query over dense rows, densified in the prologue
  constexpr bool densify = !same && dense;
  // CP rows and TT rows of ranks <= 4 are staged a warp's candidates at a
  // time; dense rows and TT rows of ranks 5-16 go through the warps' ring
  // slots where the plan gave them one (Shape::tt_ring), else are read in
  // place; the ring instances (any query format) also search a bucket's two
  // bounds at once and merge the warps' lists by flat ranks
  constexpr bool stage_rows = !dense && TR <= 4 && !(TR == 0 && QR == 16);
  constexpr bool tt_ring = Shape<TR, QR>::tt_ring;
  constexpr bool ring_rows = dense || tt_ring;
  // CP or dense queries over TT rows of ranks <= 4: two rows a warp, a row
  // a half-warp, staged in one buffer
  constexpr bool tt_pair = Shape<TR, QR>::tt_pair;
  // TT queries over CP rows: two rows a warp, a row a half-warp, staged in
  // two buffers (wide, <0, 16>: where the plan gave them room, RSLOT the
  // staged row's floats, else read in place)
  constexpr bool cp_pair = Shape<TR, QR>::cp_pair;
  constexpr bool wide = cp_pair && QR == 16;
  constexpr int kBufs = Shape<TR, QR>::buffers;
  constexpr int kThreads = Shape<TR, QR>::threads;
  constexpr int nwarps = kThreads / 32;
  // candidates a warp scores at once
  constexpr int G = Shape<TR, QR>::per_warp;
  extern __shared__ __align__(16) unsigned char smem[];
  const int LT = L * T;
  // floats of a query row as given
  const int FQ = qtt ? N * RQ * D * RQ : !same && qdense ? DF : N * D * RQ;
  // floats of the query row staged in shared memory: all but a long dense
  // one, or a CP / TT query's densified row up to kDenseStage floats; the
  // wide branch's TT query at the wide_row stride
  const int FQS = densify ? (DF <= kDenseStage ? DF : 0)
                  : wide ? N * RQ * wide_row(D, RQ)
                  : !qdense || FQ <= kDenseStage ? FQ : 0;
  const int FCMAX = wide ? RSLOT
                    : !stage_rows ? 0
                    : ((tt ? N * RCMAX * D * RCMAX : N * D * RCMAX) + 3) & ~3;
  // each warp's TT chain scratch: <4, 4>'s two chains' states; tt_chain's
  // transposed state and T tile (2E^2 floats a chain) for the two chains of
  // <8, 8> and <16, 16> and the row's own chain of <16, 0>, and its two
  // slice buffers (2E^2) for rows read in place; none where the states live
  // in registers (the TT pair branches, <16, kDense>); block_tt_self's for
  // <0, 16>; one_state: only the TT query's own chain (qq), one for the
  // block
  constexpr bool one_state = Shape<TR, QR>::one_state;
  const int SW = same ? (TR == 4 ? 2 * max(RQ * RCMAX + RCMAX * RCMAX,
                                           RQ * RQ)
                         : tt ? 6 * TR * TR : 0)
                 : tt_pair || (tt_ring && qdense) ? 0
                 : wide ? RQ * RQ + RQ * D * RQ  // block_tt_self
                 : tt ? 4 * tt_tile(RCMAX) * tt_tile(RCMAX)
                 : qtt ? 2 * max(one_state ? 0 : RQ * RCMAX, RQ * RQ) : 0;
  // uint32 words of a window slot: the hash set's two slots (kSetWords)
  // and the list's entry, each an id (and, sampling, its count)
  constexpr int kSetWords = SAMPLE ? 4 : 2;
  constexpr int kSlotWords = kSetWords + (SAMPLE ? 2 : 1);
  const int RW = (max(kSlotWords * wcap, nwarps * 2 * C) + 3) & ~3;
  // a ring slot a warp (RS floats) and its mbarrier (2 floats' room), first
  const int RS = ring_rows ? RSLOT : 0;
  float* const ring = reinterpret_cast<float*>(smem);  // [nwarps][RS]
  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(ring + nwarps * RS);  // [nwarps]
  // [nwarps][kBufs][G][FCMAX]
  float* ybuf = ring + (RS ? nwarps * (RS + 2) : 0);
  // tt_chain's tiles take vector loads: their scratch comes first, 16-byte
  // aligned (the same bytes as elsewhere, so the plan is the same)
  constexpr bool chains_first = tt_ring && !qdense;
  float* const chains = ybuf + nwarps * kBufs * G * FCMAX;  // [nwarps][SW]
  unsigned long long* wl_all = reinterpret_cast<unsigned long long*>(
      chains + (chains_first ? nwarps * SW : 0));     // [nwarps][topk]
  unsigned long long* topv = wl_all + nwarps * topk;  // [topk]
  uint32_t* region = reinterpret_cast<uint32_t*>(topv + topk);  // [RW]
  float* qf = reinterpret_cast<float*>(region + RW);  // [FQ]
  // [one_state ? 1 : nwarps][SW]
  float* sbuf = chains_first ? chains : qf + FQS;
  uint32_t* qkeys = reinterpret_cast<uint32_t*>(
      qf + FQS + (chains_first ? 0 : (one_state ? 1 : nwarps) * SW));
  int* starts = reinterpret_cast<int*>(qkeys + LT);   // [LT]
  int* lens = starts + LT;                            // [LT]
  int* woff = lens + LT;                              // [LT + 1]
  // sampling: the score keys beside the warps' lists and the merged one
  uint32_t* const wsk_all = reinterpret_cast<uint32_t*>(woff + LT + 1);
  uint32_t* const tsk = wsk_all + nwarps * topk;      // [topk]
  __shared__ float qq_s;
  __shared__ int ncand_s;
  __shared__ int total_s;
  __shared__ int hlog_s;
  __shared__ int scratch_s;
  __shared__ int take_s;  // the ring path's next list entry
  __shared__ float scale_s[2];  // a TT or CP pair branch's s_qy, s_yy

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // the query row's noise key (sampling)
  const uint32_t rowkey =
      SAMPLE ? fmix32(key0 ^ fmix32(key1 ^ (uint32_t)b)) : 0u;
  K1_STAMP_BEGIN

  // the query row the re-rank reads: staged, read in place, or a CP / TT
  // query's densified row
  const float* qrow;
  if constexpr (densify) {
    float* const out = FQS ? qf : qscratch + (size_t)b * DF;
    const float* const x = q + (size_t)b * FQ;
    if constexpr (qtt) {
      if (RQ <= 4)
        densify_tt<4, kThreads>(x, RQ, N, D, dims, DF, out, tid);
      else
        densify_tt<QR, kThreads>(x, RQ, N, D, dims, DF, out, tid);
    } else {
      densify_cp<kThreads>(x, RQ, N, D, dims, DF, out, tid);
    }
    qrow = out;
  } else if constexpr (wide) {
    // the query's rank rows G[x] (D * RQ floats) at the wide_row stride
    const int dr = D * RQ, xs = wide_row(D, RQ);
    for (int x = warp; x < N * RQ; x += nwarps)
      for (int i = lane; i < dr; i += 32)
        qf[(size_t)x * xs + i] = q[(size_t)b * FQ + (size_t)x * dr + i];
    qrow = qf;
  } else {
    for (int i = tid; i < FQS; i += kThreads) qf[i] = q[(size_t)b * FQ + i];
    qrow = FQS ? qf : q + (size_t)b * FQ;
  }
  for (int i = tid; i < nwarps * topk; i += kThreads) wl_all[i] = kPadSlot;
  if (tid == 0) {
    total_s = 0;
    ncand_s = 0;
    scratch_s = 0;
    if (RS) {
      for (int i = 0; i < nwarps; ++i) mbar_init(bars + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }

  // 1. keys and the multi-probe expansion, one warp per table; the warp's
  // candidate scores and deltas live in the shared region (the hash set's,
  // not yet used)
  const int NS = e2 ? 2 * K : K;
  float* sc = reinterpret_cast<float*>(region) + (size_t)warp * 2 * C;
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
  // qq of a CP or TT query over dense rows, or of a TT query of rank <= 4
  // over CP rows (<0, 4>): once per query, in the query's format, from its
  // row as given, by the last warp (which L < nwarps tables leave idle)
  // beside the keys
  constexpr bool early_qq = densify || cp_pair;
  if constexpr (early_qq && !wide) {
    if (warp == nwarps - 1) {
      const float* const qown = q + (size_t)b * FQ;
      float t;
      if constexpr (qtt)
        t = query_chain<QR>(qown, RQ, N, D, sbuf, lane);
      else
        t = cp_self(qown, RQ, N, D, lane);
      if (lane == 0) qq_s = scale_mul((float)(qs * qs), t);
    }
  }
  __syncthreads();
  if constexpr (wide) {  // <0, 16>: qq by the whole block after the keys
    const float t = block_tt_self<kThreads>(qf, RQ, N, D, sbuf, tid);
    if (tid == 0) qq_s = scale_mul((float)(qs * qs), t);
  }
  if (!early_qq && warp == 0) {  // qq once per query, in the query's format
    float t = 0.f;
    if constexpr (!same) {
      float unused;
      if constexpr (qdense) {
        const float* qa[1] = {qrow};
        const bool qvec = (DF & 3) == 0 &&
                          (reinterpret_cast<uintptr_t>(qrow) & 15) == 0;
        dense_dots<1, false>(qrow, qa, DF, qvec, lane, &unused, &t);
      } else {  // CP queries over TT rows (TT queries form qq early)
        t = cp_self(qf, RQ, N, D, lane);
      }
    } else if constexpr (dense) {
      const float* qa[1] = {qrow};
      const bool qvec = (D & 3) == 0 &&
                        (reinterpret_cast<uintptr_t>(qrow) & 15) == 0;
      float unused;
      dense_dots<1, false>(qrow, qa, D, qvec, lane, &unused, &t);
    } else if constexpr (TR == 4) {
      float unused;
      tt_chains<TR>(qf, RQ, qf, RQ, nullptr, 0, nullptr, 0, N, D, sbuf, lane,
                    &t, &unused);
    } else if constexpr (tt) {
      t = tt_self<TR>(qf, RQ, N, D, sbuf, nullptr, lane, false);
    } else {
      const float* qa[1] = {qf};
      for (int p = lane; p < RQ * RQ; p += 32)
        pair_terms<1>(qa, RQ, qa, RQ, N, D, p / RQ, p % RQ, &t);
      t = warp_sum(t);
    }
    if (lane == 0) qq_s = scale_mul((float)(qs * qs), t);
  }
  for (int i = tid; i < kSetWords * wcap; i += kThreads) region[i] = kEmpty;
  __syncthreads();
  K1_STAMP(0)
  const float qq = qq_s;
  float* const yb = ybuf + warp * kBufs * G * FCMAX;
  float* const sb = sbuf + warp * SW;
  unsigned long long* const wl = wl_all + warp * topk;
  uint32_t* const ws = wsk_all + warp * topk;  // sampling: its score keys
  unsigned long long thr = kPadSlot;  // the last key of the warp's list
  unsigned ring_phase = 0;            // the parity of the warp's slot
  // qy and yy of a TT row y of ranks 5-16 (a <16, QR> cross pair's row
  // longer than kTTPairRow too) against the block's query, on the warp: a
  // dense query's by dense_tt_rows; a TT query's by the two chains at once
  // (tt_pair_chains); a CP query's yy by the row's own chain (tt_self), qy
  // by cp_tt_rows
  auto tt_scores = [&](const float* y, int RC, bool in_place, float* tqy,
                       float* tyy) {
    if constexpr (!tt_ring) {
    } else if constexpr (qdense) {
      dense_tt_rows(qrow, y, RC, N, D, dims, DF, lane, tqy, tyy);
    } else if constexpr (same) {
      tt_pair_chains<TR>(qf, RQ, y, RC, N, D, sb, lane, in_place, tqy, tyy);
    } else {
      constexpr int E2 = 2 * 8 * 8;  // rank <= 8: the tiles, then the slices
      K1_PART_BEGIN
      *tyy = RC <= 8 ? tt_self<8>(y, RC, N, D, sb, sb + E2, lane, in_place)
                     : tt_self<16>(y, RC, N, D, sb, sb + 4 * E2, lane,
                                   in_place);
      K1_PART(0)
      *tqy = RC <= 8 ? cp_tt_rows<8>(qf, RQ, y, RC, N, D, lane)
                     : cp_tt_rows<16>(qf, RQ, y, RC, N, D, lane);
      K1_PART(1)
    }
  };

  for (int si = 0; si < S; ++si) {
    const Seg g = load_seg(segtab + (size_t)si * 12);
    if (g.m == 0) continue;
    const bool has_win = g.live_rank != nullptr;
    const size_t m = (size_t)g.m;

    // 2. bucket bounds, one warp per (table, probe)
    for (int i = warp; i < LT; i += nwarps) {
      const int l = i / T;
      const uint32_t key = qkeys[i];
      const long long* sk = g.sorted_keys + (size_t)l * m;
      int start, end;
      if constexpr (ring_rows) {
        warp_bounds(sk, g.m, key, lane, &start, &end);
        if (!has_win) end = min(end, start + g.cap);
      } else {
        start = warp_bound(sk, 0, g.m, key, false, lane);
        const int hi = has_win ? g.m : min(g.m, start + g.cap);
        end = warp_bound(sk, start, hi, key, true, lane);
      }
      if (lane == 0) {
        if (has_win) {
          const int* lr = g.live_rank + (size_t)l * (m + 1);
          const int r0 = lr[start];
          starts[i] = r0;
          lens[i] = min(g.cap, lr[end] - r0);
        } else {
          starts[i] = start;
          lens[i] = end - start;
        }
      }
    }
    __syncthreads();
    K1_STAMP(1)
    if (tid == 0) {
      ncand_s = 0;
      take_s = 0;
      if constexpr (tt_pair || cp_pair) {
        scale_s[0] = (float)(qs * g.cs);
        scale_s[1] = (float)(g.cs * g.cs);
      }
      woff[0] = 0;
      for (int i = 0; i < LT; ++i) woff[i + 1] = woff[i] + lens[i];
      const int pw = pow2_ceil(woff[LT]);
      hlog_s = 32 - __clz(pw);  // log2 of the set's 2 * pw slots
      if (pw > wcap) scratch_s = 1;
    }
    __syncthreads();

    // 3. dedup: the window's live ids into the hash set, and each new one
    // onto the candidate list, in shared memory while pow2(W) <= wcap, else
    // in the query's row of the scratch
    const int W = woff[LT];
    const int hlog = hlog_s;
    const int H = 1 << hlog;
    uint32_t* const ht = H <= 2 * wcap
                             ? region
                             : scratch + (size_t)b * kSlotWords * (size_t)scap;
    uint32_t* const cl =
        ht + (H <= 2 * wcap ? kSetWords * wcap : kSetWords * scap);
    // sampling: the list entries' raw hit counts
    uint32_t* const cm = cl + (H <= 2 * wcap ? wcap : scap);
    for (int i0 = tid; i0 < W; i0 += 4 * kThreads) {
      uint32_t ids[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreads;
        ids[u] = i < W ? slot_id(g, has_win, T, LT, woff, starts, i) : kEmpty;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (SAMPLE) {
          if (ids[u] < (uint32_t)g.m) set_count(ht, 32 - hlog, ids[u]);
        } else {
          if (ids[u] < (uint32_t)g.m && set_insert(ht, 32 - hlog, ids[u]))
            cl[atomicAdd(&ncand_s, 1)] = ids[u];
        }
      }
    }
    __syncthreads();
    if constexpr (SAMPLE) {
      // the set's members onto the list with their counts, the set emptied
      // for the next segment as it is read
      for (int i = tid; i < H; i += kThreads) {
        const uint32_t id = ht[2 * i];
        if (id != kEmpty) {
          const int p = atomicAdd(&ncand_s, 1);
          cl[p] = id;
          cm[p] = ht[2 * i + 1] + 1u;
          ht[2 * i] = kEmpty;
          ht[2 * i + 1] = kEmpty;
        }
      }
      __syncthreads();
    }
    K1_STAMP(2)
    const int n_cand = ncand_s;
    if (tid == 0) total_s += n_cand;
    if constexpr (!SAMPLE)
      for (int i = tid; i < H; i += kThreads) ht[i] = kEmpty;  // for the next

    // 4. exact re-rank, entering each candidate's selection key into its
    // warp's list. Dense rows that fill a ring slot: each warp takes the
    // list's next entry (take_s), its lane 0 copies the row into the warp's
    // slot with one bulk copy, and the warp scores it from shared memory.
    // Otherwise G candidates a warp at a time (the list's j = G * warp + k,
    // then j + G * nwarps + k, ...): the warp stages the next candidates'
    // rows and effective ids while it scores the current ones.
    const int RC = g.rc;
    const int FC = g.fc;
    const float s_qy = (float)(qs * g.cs), s_yy = (float)(g.cs * g.cs);
    const bool vec = (FC & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(g.c) & 15) == 0 &&
                     (!dense || (reinterpret_cast<uintptr_t>(qrow) & 15) == 0);
    if (RS && FC == RS && vec) {
      float* const slot = ring + warp * RS;
      while (true) {
        int j = 0;
        if (lane == 0) j = atomicAdd(&take_s, 1);
        j = __shfl_sync(kFull, j, 0);
        if (j >= n_cand) break;
        const uint32_t c = cl[j];
        if (lane == 0) {
          bulk_row(slot, g.c + (size_t)c * FC, (unsigned)FC * 4u,
                   bars + warp);
          // the row a warp takes a round later: into L2 now
          if (j + nwarps < n_cand)
            prefetch_l2(g.c + (size_t)cl[j + nwarps] * FC, (unsigned)FC * 4u);
        }
        const int eff = __ldg(g.eff + c);
        mbar_wait(bars + warp, ring_phase);
        ring_phase ^= 1u;
        float tqy, tyy;
        if constexpr (tt_ring) {
          tt_scores(slot, RC, false, &tqy, &tyy);
        } else {
          const float* yr[1] = {slot};
          dense_dots<1, false>(qrow, yr, FC, true, lane, &tqy, &tyy);
        }
        const unsigned long long key =
            select_key(qq, tqy, tyy, s_qy, s_yy, euclid, eff);
        if constexpr (SAMPLE)
          thr = sample_insert(wl, ws, topk, key, cm[j], mode, rowkey, thr,
                              lane);
        else if (key < thr)
          thr = topk_insert(wl, topk, key, lane);
        __syncwarp();  // every lane has read the slot before it is refilled
      }
      K1_STAMP(3)
      continue;
    }
    if constexpr (tt_pair) {
      // CP or dense queries over TT rows of ranks <= 4: the warp takes list
      // entries j, j + 1, then j + 2 * nwarps, ..., stages both rows into
      // its buffer (a missing second row leaves its half the buffer's old
      // contents, and its score is dropped), sends the rows it takes next
      // into L2 while these land, and scores a row a half-warp: yy by
      // tt_self_half, qy by cp_tt_half or, for a dense query,
      // dense_tt_sweep
      static_assert(G == 2, "a TT pair branch scores two rows a warp");
      const float* const mine = yb + (lane >> 4) * FCMAX;  // the half's row
      const int h = lane & 15;
      for (int j = warp * 2; j < n_cand; j += 2 * nwarps) {
        const bool two = j + 1 < n_cand;
        const uint32_t c0 = cl[j], c1 = two ? cl[j + 1] : c0;
        stage_row(yb, g.c + (size_t)c0 * FC, FC, vec, lane);
        if (two) stage_row(yb + FCMAX, g.c + (size_t)c1 * FC, FC, vec, lane);
        cp_async_commit();
        const int jn = j + 2 * nwarps + lane;
        if (vec && lane < 2 && jn < n_cand)
          prefetch_l2(g.c + (size_t)cl[jn] * FC, (unsigned)FC * 4u);
        const int eff0 = __ldg(g.eff + c0), eff1 = __ldg(g.eff + c1);
        cp_async_wait<0>();
        __syncwarp();
        const float tyy = RC == 4 ? tt_self_half<true>(mine, RC, N, D, h)
                                  : tt_self_half<false>(mine, RC, N, D, h);
        float t;
        if constexpr (qdense) {
          // the staged query row by shared loads (qf), else where it lies
          t = RC == 4 && FQS
                  ? dense_tt_sweep<true>(qf, mine, RC, N, D, dims, DF, h)
              : RC == 4
                  ? dense_tt_sweep<true>(qrow, mine, RC, N, D, dims, DF, h)
                  : dense_tt_sweep<false>(qrow, mine, RC, N, D, dims, DF, h);
        } else {
          t = RC == 4 ? cp_tt_half<true>(qf, RQ, mine, RC, N, D, h)
                      : cp_tt_half<false>(qf, RQ, mine, RC, N, D, h);
        }
        if constexpr (SAMPLE)
          sample_pair(t, tyy, eff0, eff1, cm[j], two ? cm[j + 1] : 0u, two,
                      qq_s, scale_s, euclid, wl, ws, topk, mode, rowkey,
                      lane);
        else
          select_pair(t, tyy, eff0, eff1, two, qq_s, scale_s, euclid, wl,
                      topk, lane);
        __syncwarp();  // both rows are read before the next pair is staged
      }
      K1_STAMP(3)
      continue;
    }
    if constexpr (cp_pair) {
      // TT queries of ranks <= 4 over CP rows: the warp takes list entries
      // j, j + 1, then j + 2 * nwarps, ..., stages the next pair's rows into
      // its other buffer while it scores these (a missing second row leaves
      // its half a buffer's old contents, and its score is dropped), a row a
      // half-warp: yy by the row's Grams (its (r, q) terms on the half), qy
      // by cp_tt_half with the roles swapped (inner_cp_tt(row, query): the
      // staged CP row is the CP operand, the query's cores in qf the TT one)
      static_assert(G == 2 && kBufs == 2, "a CP pair branch double-buffers "
                                          "two rows a warp");
      const int h = lane & 15;
      // a rank-4 query's rank rows are 16-byte loads where qf is aligned
      const bool qv4 = RQ == 4 && (reinterpret_cast<uintptr_t>(qf) & 15) == 0;
      // the wide branch reads its rows in place where the plan staged none
      const bool staged = !wide || FCMAX != 0;
      int j = warp * 2;
      if (staged && j < n_cand) {
        stage_row(yb, g.c + (size_t)cl[j] * FC, FC, vec, lane);
        if (j + 1 < n_cand)
          stage_row(yb + FCMAX, g.c + (size_t)cl[j + 1] * FC, FC, vec, lane);
      }
      cp_async_commit();
      for (int half = 0; j < n_cand; j += 2 * nwarps, half ^= 1) {
        const int jn = j + 2 * nwarps;
        float* const next = yb + (half ^ 1) * 2 * FCMAX;
        if (staged && jn < n_cand) {
          stage_row(next, g.c + (size_t)cl[jn] * FC, FC, vec, lane);
          if (jn + 1 < n_cand)
            stage_row(next + FCMAX, g.c + (size_t)cl[jn + 1] * FC, FC, vec,
                      lane);
        }
        cp_async_commit();
        const bool two = j + 1 < n_cand;
        const int eff0 = __ldg(g.eff + cl[j]);
        const int eff1 = two ? __ldg(g.eff + cl[j + 1]) : 0;
        cp_async_wait<1>();  // this pair's rows have landed
        __syncwarp();
        const float* yh[1] = {
            staged ? yb + (half * 2 + (lane >> 4)) * FCMAX
                   : g.c + (size_t)cl[two ? j + (lane >> 4) : j] * FC};
        float tyy = 0.f;
        for (int p = h; p < RC * RC; p += 16)
          pair_terms<1>(yh, RC, yh, RC, N, D, p / RC, p % RC, &tyy);
        for (int o = 8; o > 0; o >>= 1)
          tyy += __shfl_xor_sync(kFull, tyy, o);
        float t;
        if constexpr (wide)
          t = cp_tt_wides(yh[0], RC, qf, RQ, N, D, h);
        else
          t = qv4 ? cp_tt_half<true>(yh[0], RC, qf, RQ, N, D, h)
                  : cp_tt_half<false>(yh[0], RC, qf, RQ, N, D, h);
        if constexpr (SAMPLE)
          sample_pair(t, tyy, eff0, eff1, cm[j], two ? cm[j + 1] : 0u, two,
                      qq_s, scale_s, euclid, wl, ws, topk, mode, rowkey,
                      lane);
        else
          select_pair(t, tyy, eff0, eff1, two, qq_s, scale_s, euclid, wl,
                      topk, lane);
        __syncwarp();  // both rows are read before the buffer is staged again
      }
      cp_async_wait<0>();
      K1_STAMP(3)
      continue;
    }
    int j = warp * G;
    uint32_t cur[G];
    int cur_eff[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      cur[k] = j + k < n_cand ? cl[j + k] : kEmpty;
      cur_eff[k] = 0;
      if (cur[k] != kEmpty) {
        if constexpr (stage_rows)
          stage_row(yb + k * FCMAX, g.c + (size_t)cur[k] * FC, FC, vec, lane);
        cur_eff[k] = __ldg(g.eff + cur[k]);
      }
    }
    cp_async_commit();
    int half = 0;
    while (cur[0] != kEmpty) {
      j += G * nwarps;
      uint32_t nxt[G];
      int nxt_eff[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        nxt[k] = j + k < n_cand ? cl[j + k] : kEmpty;
        nxt_eff[k] = 0;
        if (nxt[k] != kEmpty) {
          if constexpr (stage_rows)
            stage_row(yb + ((half ^ 1) * G + k) * FCMAX,
                      g.c + (size_t)nxt[k] * FC, FC, vec, lane);
          nxt_eff[k] = __ldg(g.eff + nxt[k]);
        }
      }
      cp_async_commit();
      cp_async_wait<1>();  // the current rows have landed
      __syncwarp();
      const float* yr[G];
      float tqy[G], tyy[G];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        // an empty slot past the list's end reads the first row again (an
        // index into cur, not a select of its values: the select spills)
        yr[k] = stage_rows ? yb + (half * G + k) * FCMAX
                           : g.c + (size_t)cur[cur[k] == kEmpty ? 0 : k] * FC;
        tqy[k] = 0.f;
        tyy[k] = 0.f;
      }
      if constexpr (dense) {
        dense_dots<G>(qrow, yr, same ? D : DF, vec, lane, tqy, tyy);
      } else if constexpr (!same && !tt && qdense) {  // two CP rows
        static_assert(G == 2, "dense x CP scores two rows a warp");
        // yy by each row's Grams, its (r, q) terms on a half-warp
        const float* yh[1] = {lane < 16 ? yr[0] : yr[1]};
        float t = 0.f;
        for (int p = lane & 15; p < RC * RC; p += 16)
          pair_terms<1>(yh, RC, yh, RC, N, D, p / RC, p % RC, &t);
        for (int o = 8; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
        tyy[0] = __shfl_sync(kFull, t, 0);
        tyy[1] = __shfl_sync(kFull, t, 16);
        dense_cp_sweep<G>(qrow, yr, RC, N, dims, DF, lane, tqy);
      } else if constexpr (tt_ring) {  // TT rows read in place, G = 1
        tt_scores(yr[0], RC, true, tqy, tyy);
      } else if constexpr (tt) {  // <4, 4>, G = 1
        tt_chains<TR>(qf, RQ, yr[0], RC, yr[0], RC, yr[0], RC, N, D, sb,
                      lane, tqy, tyy);
      } else {
        const float* qa[G];
#pragma unroll
        for (int k = 0; k < G; ++k) qa[k] = qf;
        for (int p = lane; p < RQ * RC + RC * RC; p += 32) {
          if (p < RQ * RC) {
            pair_terms<G>(qa, RQ, yr, RC, N, D, p / RC, p % RC, tqy);
          } else {
            const int p2 = p - RQ * RC;
            pair_terms<G>(yr, RC, yr, RC, N, D, p2 / RC, p2 % RC, tyy);
          }
        }
#pragma unroll
        for (int k = 0; k < G; ++k) {
          tqy[k] = warp_sum(tqy[k]);
          tyy[k] = warp_sum(tyy[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (cur[k] == kEmpty) continue;
        const unsigned long long key =
            select_key(qq, tqy[k], tyy[k], s_qy, s_yy, euclid, cur_eff[k]);
        if constexpr (SAMPLE)  // cur holds list entries j - G * nwarps + k
          thr = sample_insert(wl, ws, topk, key, cm[j - G * nwarps + k],
                              mode, rowkey, thr, lane);
        else if (key < thr)
          thr = topk_insert(wl, topk, key, lane);
      }
      __syncwarp();  // the rows' half is read before it is staged again
#pragma unroll
      for (int k = 0; k < G; ++k) {
        cur[k] = nxt[k];
        cur_eff[k] = nxt_eff[k];
      }
      half ^= 1;
    }
    cp_async_wait<0>();
    K1_STAMP(3)
  }
  __syncthreads();
  K1_STAMP(3)

  // 5. the warps' lists merged by rank, then ids, scores and the count. A
  // key's rank: the keys before it in the lists' concatenation at most it,
  // and those after it below it (equal keys are pads, and rank in order);
  // counted flat (every key against every other, loads every thread shares)
  // or by binary search in the other lists.
  for (int e = tid; e < nwarps * topk; e += kThreads) {
    const unsigned long long x = wl_all[e];
    int r = 0;
    if constexpr (ring_rows) {
#pragma unroll 8
      for (int f = 0; f < nwarps * topk; ++f) {
        const unsigned long long y = wl_all[f];
        r += f < e ? y <= x : y < x;
      }
    } else {
      const int wv = e / topk;
      r = e - wv * topk;
      for (int v = 0; v < nwarps && r < topk; ++v)
        if (v != wv) r += count_below(wl_all + v * topk, topk, x, v < wv);
    }
    if (r < topk) {
      topv[r] = x;
      if constexpr (SAMPLE) tsk[r] = wsk_all[e];
    }
  }
  __syncthreads();
  const float bad = __uint_as_float(euclid ? 0x7f800000u : 0xff800000u);
  if constexpr (SAMPLE) {
    // the drawn members (the first topk sampling keys; pads last) in the
    // top-k path's order: a member's place is the number of drawn members
    // whose (score key, eff) is below its own
    for (int i = tid; i < topk; i += kThreads) {
      const unsigned long long s = topv[i];
      if (s == kPadSlot) {
        out_ids[(size_t)b * topk + i] = -1;
        out_scores[(size_t)b * topk + i] = bad;
        continue;
      }
      const unsigned long long own =
          ((unsigned long long)tsk[i] << 32) | (s & 0xFFFFFFFFull);
      int r = 0;
      for (int f = 0; f < topk; ++f) {
        const unsigned long long o = topv[f];
        r += o != kPadSlot &&
             (((unsigned long long)tsk[f] << 32) | (o & 0xFFFFFFFFull)) < own;
      }
      const uint32_t key32 = tsk[i];
      const uint32_t bits = (key32 >> 31) ? (key32 & 0x7FFFFFFFu) : ~key32;
      const float order = __uint_as_float(bits);
      out_ids[(size_t)b * topk + r] = (int)(uint32_t)(s & 0xFFFFFFFFull);
      out_scores[(size_t)b * topk + r] = euclid ? order : -order;
    }
  } else {
    for (int i = tid; i < topk; i += kThreads) {
      int id = -1;
      float score = bad;
      const unsigned long long s = topv[i];
      const uint32_t key32 = (uint32_t)(s >> 32);
      if (key32 != kEmpty) {
        id = (int)(uint32_t)(s & 0xFFFFFFFFull);
        const uint32_t bits = (key32 >> 31) ? (key32 & 0x7FFFFFFFu) : ~key32;
        const float order = __uint_as_float(bits);
        score = euclid ? order : -order;
      }
      out_ids[(size_t)b * topk + i] = id;
      out_scores[(size_t)b * topk + i] = score;
    }
  }
  if (tid == 0) {
    out_ncand[b] = total_s;
    if (scratch_s) atomicAdd(scratch_queries, 1ull);
  }
  K1_STAMP(4)
  K1_STAMP_END(b)
}


// The instantiation codes (TR, QR) of a corpus format fmt and a query format
// qfmt (0 CP, 1 TT, 2 dense), their ranks and the CP / TT operand's N and D:
// a same-format pair's TR bounds both ranks (0 CP, kDense, 4 / 8 / 16 TT)
// and QR = TR; a cross-format pair's codes are each operand's own: a TT
// corpus's 4 for ranks <= 4 and rows of at most kTTPairRow floats, else 16;
// a TT query's 4 over CP rows of at most kCPPairRow floats for ranks <= 4,
// else 16 (over dense rows its chain and its densified row run once a
// block). -1 where no instantiation takes the ranks.
inline void instance_of(int fmt, int qfmt, int RQ, int RC, int N, int D,
                        int* tr, int* qr) {
  auto code = [](int f, int r, int least) {
    return f == 0 ? 0 : f == 2 ? kDense : f != 1 ? -1
           : r <= least ? least : r <= 16 ? 16 : -1;
  };
  if (fmt != qfmt) {
    *tr = code(fmt, RC, 4);
    if (*tr == 4 && (long long)N * RC * D * RC > kTTPairRow) *tr = 16;
    *qr = code(qfmt, RQ, *tr == 0 ? 4 : 16);
    if (*qr == 4 && (long long)N * D * RC > kCPPairRow) *qr = 16;
    return;
  }
  int t = -1;
  if (fmt == 0) t = 0;
  else if (fmt == 2) t = kDense;
  else if (fmt == 1)
    t = RQ <= 4 && RC <= 4 ? 4 : RQ <= 8 && RC <= 8 ? 8
        : RQ <= 16 && RC <= 16 ? 16 : -1;
  *tr = *qr = t;
}

// Up to smem bytes of dynamic shared memory, and all of the SM's 228 KB as
// shared memory (not L1), so that Shape<TR, QR>::min_blocks can be resident.
// A function's attributes are set in each card's context, so what was set
// is kept per card (the current one, which the wrappers pin).
constexpr int kMaxCards = 64;

template <int TR, int QR, bool SAMPLE = false>
cudaError_t prepare(size_t smem) {
  static size_t allowed[kMaxCards] = {};
  static bool carved[kMaxCards] = {};
  int card = 0;
  cudaError_t e = cudaGetDevice(&card);
  if (e != cudaSuccess) return e;
  if (card < 0 || card >= kMaxCards) return cudaErrorInvalidDevice;
  if (!carved[card]) {
    e = cudaFuncSetAttribute(fused_query_kernel<TR, QR, SAMPLE>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    carved[card] = true;
  }
  if (smem > allowed[card]) {
    e = cudaFuncSetAttribute(fused_query_kernel<TR, QR, SAMPLE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    allowed[card] = smem;
  }
  return cudaSuccess;
}

template <int TR, int QR, bool SAMPLE = false>
int occupancy(size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e =
      cudaFuncGetAttributes(&a, fused_query_kernel<TR, QR, SAMPLE>);
  if (e == cudaSuccess) e = prepare<TR, QR, SAMPLE>(smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fused_query_kernel<TR, QR, SAMPLE>, Shape<TR, QR>::threads,
        smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = blocks;
  out[2] = (int)a.localSizeBytes;
  out[3] = Shape<TR, QR>::min_blocks;
  return 0;
}

template <int TR, int QR, bool SAMPLE = false>
int launch(const K1Args& a, size_t smem, cudaStream_t stream) {
  const cudaError_t e = prepare<TR, QR, SAMPLE>(smem);
  if (e != cudaSuccess) return (int)e;
  fused_query_kernel<TR, QR, SAMPLE>
      <<<a.B, Shape<TR, QR>::threads, smem, stream>>>(
          a.values, a.offsets, a.mults, a.pairs, a.q, a.segtab, a.S,
          a.out_ids, a.out_scores, a.out_ncand, a.L, a.K, a.T, a.C, a.N, a.D,
          a.RQ, a.RC, a.topk, a.e2, a.euclid, a.w, a.qs, a.wcap, a.scratch,
          a.scap, a.scratch_queries, a.qscratch, a.dims, a.DF, a.RS, a.mode,
          a.key0, a.key1);
  return (int)cudaGetLastError();
}

}  // namespace
