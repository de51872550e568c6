"""K1: one launch from a query batch's raw projections to (id, score) pairs
over every segment of a store (reference:
``repro.kernels.fused_query.fused_query``).

Stages, per query: discretize (E2LSH floor / SRP sign) -> uint32 radix
combine -> multi-probe expansion to T ranked keys per table -> per segment:
per-(table, probe) binary search over the sorted bucket keys, the dense
cap-wide window (bucket members, tombstones masked) or the live window
(the first ``cap`` live members, through ``live_rank`` / ``live_pos``),
sort-dedup, exact re-rank (CP Grams, the TT chain, or dense rows: qy and
yy over prod d floats; a query batch of another format than the corpus's
through the cross-format pair's contraction, qq in the query's format and
yy in the corpus's), packed (order key, effective id) keys -> top-k over
all segments.

``fused_query`` launches the CUDA kernel ``csrc/fused_query.cu`` on CUDA
tensors and runs ``fused_query_plain`` on CPU tensors; any other device
raises. The plain version composes ``core.probing``'s expansion,
``kernels.epilogues``' probe helpers and ``core.segments.hoisted_scores``
exactly as the reference's ``_fused_query_kernel`` does: every segment's
packed candidates are concatenated and one ``packed_select`` picks the
top-k. The kernel instead keeps a running top-k across segments; the packed
key is a strict total order on valid slots (effective ids are unique in a
store), so both pick the same keys in the same order. Both take the raw
projections as an input, so the two can be held against each other on the
same values (``LSHFamily.raw_stacked`` makes them with K3 or K4 on the main
path), and both take the query batch as its format's ``stack`` gives it.

K1s, the sharded entry (``fused_query_sharded``, reference
``fused_query_sharded``), is the same CUDA kernel launched once over every
(shard, segment) pair of a sharded store, shard-major (``shard_segments``):
each shard's base slice and delta slabs are rows of the segment table with
their own ``m`` and cap, pad slots (perm entry ``m``, ``live[m]`` False)
are misses like tombstones, and the running top-k over all rows takes the
place of the reference's S-way merge (effective ids are unique across
shards). Its plain version, ``fused_query_sharded_plain``, is
``fused_query_plain``'s body over the same list.

The sampling modes (``mode`` "uniform" / "weighted", reference
``segmented_sample`` / ``_sample_topk``) draw ``topk`` distinct members of
each query's probed union instead of the top-k, by Gumbel top-k: a member's
logit is 0 or log(its raw hit count over the (table, probe) windows), its
noise a counter-based hash of the draw's two key words (``key``, drawn from
a ``torch.Generator`` by ``sample_key_words``), the query row and its
effective id (``noise_bits`` / ``sample_key32``), so the draw depends on
neither the order of the candidates nor the segment or shard holding them.
The kernel's sampling instantiations (``csrc/fused_query_sample*.cu``)
count each distinct id's hits beside its hash-set slot, score every
distinct candidate as the top-k path does, keep the first ``topk`` by the
sampling key and write them in the top-k path's order; the plain version
(``_plain_sample``) sorts the raw windows by id and takes run lengths
(``segment_union``), as the reference does.

The kernel dedups a query's window in a hash set in shared memory of a
fixed capacity, chosen for occupancy (``window_plan``); a query whose
window exceeds it in a segment uses its row of a global scratch table that
the wrapper allocates once per segment table (so once per published store
view) and the kernel leaves empty: the same code, so the answers do not
depend on where the set lived.

``fused_query.launches`` / ``fused_query_sharded.launches`` count kernel
launches and ``.branches`` (``BranchCounts``) the launches that ran each
branch ("multiprobe": T > 1, "live_window": a segment with live-window
lookups, "segments": more than one segment, "mixed:<query>-<corpus>": a
query batch of another format than the corpus's, e.g. "mixed:dense-cp")
and each instantiation ("k1:<TR, QR>", ``instance_name``, e.g. "k1:<0, 4>";
a sampling launch counts under "sample:<mode>" and its instantiation's
"sample:<TR, QR>" instead), and the queries that took the scratch
("scratch", counted on the card and read from it when asked for);
``fused_query_plain.calls`` / ``fused_query_sharded_plain.calls`` count
calls of the plain versions.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import struct

import torch

from repro_torch.core import probing
from repro_torch.core import segments as _seg
from repro_torch.kernels import epilogues as _epi
from repro_torch.kernels.counts import LOCK, count_launch, counted
from repro_torch.kernels.epilogues import (BLOCK_RESERVED, MAX_SMEM,
                                           SM_SMEM, SMEM_GRANULE)

STATIC_SMEM = 32           # bytes of K1's static shared scalars, at most
MAX_TT_RANK = 16           # largest TT rank K1's chains take
MAX_DENSE_ROW = 65536      # longest dense row (floats) K1 takes (kMaxDenseRow)
DENSE_STAGE = 8192         # longest dense query row staged (kDenseStage)
RING_ROW = 2048            # longest dense row a warp's ring slot holds
TABLE_COLS = 12            # int64 words per segment in the K1 table
DENSE = 1                  # TR of the dense-row instantiation (kDense)
MAX_MODES = 16             # most modes of a cross pair with a dense side
# longest TT row (floats) CP or dense queries over TT rows of ranks <= 4
# stage (kTTPairRow): longer rows go to TR = 16, which reads them in place
TT_PAIR_ROW = 1024
# longest CP row (floats) TT queries of ranks <= 4 over CP rows stage
# (kCPPairRow): longer rows go to QR = 16, which stages them where its plan
# finds room (``slot_plan``), else reads them in place
CP_PAIR_ROW = 256
# longest TT row (floats) the instantiations over TT rows of ranks 5-16 (or
# a cross pair's rows past TT_PAIR_ROW) take through a warp's ring slot
# (kTTRingRow): a rank-8 row of (12, 12, 12); longer rows are read in place
TT_RING_ROW = 2304
# the corpus's and the queries' format codes in the C entries (fmt, qfmt)
FORMATS = {"cp": 0, "tt": 1, "dense": 2}
# the six cross-format pairs, (query, corpus) layouts: BranchCounts names
# their launches "mixed:<query>-<corpus>"
MIXED_PAIRS = (("dense", "cp"), ("cp", "dense"), ("dense", "tt"),
               ("tt", "dense"), ("cp", "tt"), ("tt", "cp"))
# K1's instantiations fused_query_kernel<TR, QR> -> (threads of a query's
# block, target blocks per SM (its __launch_bounds__), candidates a warp
# scores at once, row buffers a warp keeps for each of them (two where the
# next rows are staged while the current ones are scored, one for CP or
# dense queries over TT rows of ranks <= 4; none are kept where the rows go
# through ring slots or are read in place)): Shape<TR, QR> in
# csrc/fused_query.cuh, whose C launch refuses a plan made with other
# values. TR is the corpus's code (0 CP,
# DENSE dense rows, else the TT rank bound), QR = TR for a same-format
# pair, else the query's own code (``instance``). TT x TT at ranks 5-16
# (<8, 8>, <16, 16>): 8 warps, 2 blocks, a row a warp through a ring slot
# (``TT_RING``), its two chains on the two half-warps (``tt_chain``).
SHAPES = {
    (0, 0): (384, 2, 2, 2), (DENSE, DENSE): (384, 2, 1, 2),
    (4, 4): (256, 3, 1, 2), (8, 8): (256, 2, 1, 2), (16, 16): (256, 2, 1, 2),
    # the cross-format pairs (csrc/fused_query_mixed.cu): 2 blocks; CP or TT
    # queries over dense rows the dense instantiation's shape; dense queries
    # over CP rows, CP or dense queries over TT rows of ranks <= 4 and TT
    # queries over CP rows 12 warps, two rows a warp (over TT rows in one
    # buffer), the others (CP or dense queries over TT rows of ranks 5-16)
    # 8, one row a warp through a ring slot
    (DENSE, 0): (384, 2, 1, 2), (DENSE, 16): (384, 2, 1, 2),
    (0, DENSE): (384, 2, 2, 2), (4, DENSE): (384, 2, 2, 1),
    (16, DENSE): (256, 2, 1, 2), (4, 0): (384, 2, 2, 1),
    (16, 0): (256, 2, 1, 2), (0, 4): (384, 2, 2, 2), (0, 16): (384, 2, 2, 2),
}
# the instantiations that take TT rows of ranks 5-16 through ring slots
# (Shape::tt_ring): dense, CP and TT queries over them
TT_RING = ((16, DENSE), (16, 0), (8, 8), (16, 16))
# the shared window's capacity in slots lies in [MIN_WINDOW, MAX_WINDOW]
# (or is pow2(L*T*cap) where that is smaller)
MIN_WINDOW = 256
MAX_WINDOW = 8192
# the query modes and their codes in the C entry: "topk" the exact top-k,
# "uniform" / "weighted" a Gumbel top-k sample of the probed union
MODES = {"topk": 0, "uniform": 1, "weighted": 2}
# uint32 words of a sampling launch's window slot: a hash-set slot of two
# (an id and its raw hit count, two slots a window slot) and a list entry
# of two (an id and its count); the top-k launch's slot is 3 words
SAMPLE_WORDS = 6


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def instance(layout: str, q_layout: str, rq: int, rc: int, n_modes: int,
             d: int) -> tuple[int, int]:
    """(TR, QR): the kernel instantiation for a corpus of ``layout`` and
    rank ``rc`` and queries of ``q_layout`` and rank ``rq`` (``n_modes``,
    ``d``: the CP or TT operand's), as ``instance_of`` in
    ``csrc/fused_query.cuh``: a same-format pair's TR is 0 for CP,
    ``DENSE`` for dense rows, else the smallest of 4, 8, 16 that bounds both
    TT ranks, and QR = TR; a cross-format pair's codes are each operand's
    own (0 CP, ``DENSE``, a TT corpus's 4 for ranks <= 4 and rows of at most
    ``TT_PAIR_ROW`` floats, else 16; a TT query's 4 over CP rows of at most
    ``CP_PAIR_ROW`` floats for ranks <= 4, else 16)."""
    code = {"cp": 0, "dense": DENSE}
    if layout == q_layout:
        tr = code.get(layout) if layout in code else next(
            b for b in (4, 8, 16) if max(rq, rc) <= b)
        return tr, tr
    tr = code.get(layout, 4 if rc <= 4 else 16)
    if tr == 4 and n_modes * rc * d * rc > TT_PAIR_ROW:
        tr = 16
    qr = code.get(q_layout, 16)
    if tr == 0 and qr == 16 and rq <= 4 and n_modes * d * rc <= CP_PAIR_ROW:
        qr = 4
    return tr, qr


def instance_name(tr: int, qr: int) -> str:
    """An instantiation's name as the CUDA source writes it, e.g.
    ``<0, 4>`` or ``<kDense, 16>``."""
    name = {DENSE: "kDense"}
    return f"<{name.get(tr, tr)}, {name.get(qr, qr)}>"


def ring_slot(d: int) -> int:
    """Floats of the dense instantiation's ring slot for rows of ``d``
    floats (``ring_slot`` in ``csrc/fused_query.cuh``): ``d`` where the rows
    are whole float4s of at most ``RING_ROW`` floats, else 0 (the rows are
    read in place)."""
    return d if d % 4 == 0 and d <= RING_ROW else 0


def tt_ring_slot(fc: int) -> int:
    """Floats of ``<16, kDense>``'s ring slot for TT rows of ``fc`` floats
    (``tt_ring_slot`` in ``csrc/fused_query.cuh``): ``fc`` where the rows
    are whole float4s of at most ``TT_RING_ROW`` floats, else 0."""
    return fc if fc % 4 == 0 and fc <= TT_RING_ROW else 0


def tt_tile(r: int) -> int:
    """The rank bound of ``tt_chain``'s lane tiles for TT ranks up to ``r``
    (``tt_tile`` in ``csrc/fused_query.cuh``): 8 or 16."""
    return 8 if r <= 8 else 16


def wide_row(d: int, r: int) -> int:
    """The stride (floats) of a TT query's rank rows as ``<0, 16>`` stages
    them (``wide_row`` in ``csrc/fused_query.cuh``): d * r made odd."""
    return (d * r) | 1


def column_table(dims: tuple, d: int) -> list:
    """The dense x CP re-rank's column table (``dense_cp_sweep``): a dense
    row of ``dims`` read as (d_1, P), P = prod dims[1:], and for each mode
    n >= 1 (0-based) and column p its entry's row n * ``d`` + i_n(p) in a
    stacked CP row (N, ``d``, R) -> the (N - 1) x P entries, mode-major."""
    p = torch.arange(math.prod(dims[1:]), dtype=torch.int64)
    rows = []
    for n in range(len(dims) - 1, 0, -1):
        rows.append(n * d + p % dims[n])
        p = p // dims[n]
    return torch.stack(rows[::-1]).flatten().tolist() if rows else []


def smem_bytes(num_tables: int, n_modes: int, d: int, rq: int, rc: int,
               window: int, tt: bool = False, probes: int = 1,
               topk: int = 10, expansion: int = 0,
               dense: bool = False, q_layout: str | None = None,
               df: int = 0, ring: bool = False, sample: bool = False) -> int:
    """Shared memory of one K1 block (``fused_query_smem_bytes`` in the CUDA
    source, which refuses a launch planned with another size) for a shared
    window of ``window`` slots (a power of two): the instantiation's row
    buffers a warp (``SHAPES``) for each candidate it scores at once (two
    for CP, one for TT; CP factors (N, d, R) or TT cores (N, R, d, R) of
    ranks up to 4, rounded up to 4 floats; TT rows of ranks 5-16, and those
    a cross pair's TR = 16 takes, go through ring slots or are read in
    place), the warps' running top-k lists and the
    merged top-k (8 bytes a rank each), the hash set of 2 * window ids and the
    candidate list of window ids (the expansion's per-warp scores and deltas,
    ``expansion`` candidates of 8 bytes, reuse that region), the query's row,
    for TT each warp's chain scratch (at ranks <= 4 the two chain states and
    their next values, at ranks 5-16 ``tt_chain``'s two tiles of
    ``tt_tile``^2 floats for each of the two chains and two slice buffers
    as large), four per-(table,
    probe) integer arrays, and ``STATIC_SMEM`` bytes of static scalars. A
    dense corpus (``dense``: n_modes = rq = rc = 1, d = prod d) stages no
    candidate rows and its query row only up to ``DENSE_STAGE`` floats;
    with ``ring`` (rows of at most ``RING_ROW`` whole float4s: ``ring_plan``)
    a ring slot a warp and its 8-byte mbarrier (``ring_slot``).
    Queries of another layout (``q_layout``; ``n_modes`` and ``d`` are then
    the CP or TT operand's, ``df`` = prod d the dense operand's row): the
    instantiation's warps and rows (``SHAPES``), the query row as given or,
    over dense rows, densified (a row with a dense side staged up to
    ``DENSE_STAGE`` floats; over dense rows with ``ring`` a ring slot a warp
    for rows of ``df`` floats), and the chain states of the pair's TT
    operand (none over TT rows: those states live in registers; one for the
    block where only a TT query's own chain needs one: over dense rows, and
    over CP rows; CP queries over TT rows of ranks 5-16, ``<16, 0>``: the
    row's own chain's tiles). With ``ring`` (``slot_plan``) the
    instantiations over TT rows of ranks 5-16 (``TT_RING``) take them
    through a ring slot a warp (``tt_ring_slot``), and TT queries over CP
    rows past ``CP_PAIR_ROW`` or of ranks 5-16 (``<0, 16>``) stage them
    (else both read them in place); ``<0, 16>`` stages the query's cores at
    the ``wide_row`` stride. A sampling launch (``sample``) keeps a count
    beside each hash-set id and each list entry (``SAMPLE_WORDS`` words a
    window slot instead of 3) and each list entry's score key beside its
    selection key (4 bytes a rank more)."""
    layout = "tt" if tt else "dense" if dense else "cp"
    ql = q_layout or layout
    tr, qr = instance(layout, ql, rq, rc, n_modes, d)
    threads, _, per_warp, buffers = SHAPES[tr, qr]
    nwarps = threads // 32
    wide, tt_ring = (tr, qr) == (0, 16), (tr, qr) in TT_RING
    # a candidate row staged: CP rows, TT rows of ranks <= 4; <0, 16>'s
    # CP rows only with its slots
    fc = (0 if dense or tr > 4 or (wide and not ring)
          else n_modes * rc * d * (rc if tt else 1))
    fc = -(-fc // 4) * 4 * per_warp
    # the query row: a row with a dense side (a dense query's, or a CP / TT
    # query's densified over dense rows) staged up to DENSE_STAGE floats
    dense_side = "dense" in (layout, ql)
    fq = (df if dense_side and ql != layout
          else n_modes * rq * wide_row(d, rq) if wide
          else n_modes * rq * d * (rq if ql == "tt" else 1))
    if dense_side and fq > DENSE_STAGE:
        fq = 0
    # each warp's chain scratch: a same-format pair's two TT chains (at
    # ranks 5-16 tt_chain's tiles); a cross pair's TT operand's own chain;
    # only the TT query's own chain, one for the block (Shape::one_state)
    one_state = ql == "tt" and layout in ("dense", "cp")
    if ql == layout:
        sw = (0 if not tt else 2 * max(rq * rc + rc * rc, rq * rq)
              if tr == 4 else 6 * tr * tr)
    elif tr == 4 or (tr, qr) == (16, DENSE):
        sw = 0       # the states live in registers
    elif wide:
        sw = rq * rq + rq * d * rq    # qq by the block (block_tt_self)
    elif (tr, qr) == (16, 0):
        sw = 4 * tt_tile(rc) ** 2     # the row's own chain (tt_chain)
    elif "tt" in (layout, ql):
        rt = rc if tt else rq
        sw = 2 * max(0 if dense_side or one_state else rq * rc, rt * rt)
    else:
        sw = 0
    words = SAMPLE_WORDS if sample else 3
    region = -(-max(words * window, nwarps * 2 * expansion) // 4) * 4
    lt = num_tables * probes
    rs = (ring_slot(d if ql == layout else df) if ring and dense
          else tt_ring_slot(n_modes * rc * d * rc) if ring and tt_ring
          else 0)
    slots = nwarps * (rs + 2) if rs else 0
    return ((slots + nwarps * buffers * fc + fq
             + (1 if one_state else nwarps) * sw + region) * 4
            + (nwarps + 1) * topk * (12 if sample else 8) + (4 * lt + 1) * 4
            + STATIC_SMEM)


def _budget(blocks: int) -> int:
    """Shared bytes a block may plan with ``blocks`` resident per SM."""
    return min(MAX_SMEM, SM_SMEM // blocks - BLOCK_RESERVED)


def _granules(smem: int) -> int:
    return -(-smem // SMEM_GRANULE) * SMEM_GRANULE


def ring_plan(num_tables: int, cap: int, d: int, probes: int = 1,
              topk: int = 10, expansion: int = 0,
              query: tuple | None = None, sample: bool = False) -> bool:
    """Whether K1's dense instantiations read rows of ``d`` floats through
    their warps' ring slots: rows that fit one (``ring_slot``) and a ring
    that fits the target blocks per SM beside the query row, the lists,
    the expansion and the smallest window; otherwise the rows are read in
    place. ``query``: (layout, n_modes, d, rank) of CP or TT queries (the
    densified row is ``d`` floats), None for dense ones; ``sample``: a
    sampling launch's larger window slots. The C launch tells the two plans
    apart by their shared bytes."""
    if not ring_slot(d):
        return False
    least = min(_pow2_ceil(num_tables * probes * cap), MIN_WINDOW)
    ql, n, dq, rq = query or (None, 1, d, 1)
    smem = smem_bytes(num_tables, n, dq, rq, 1, least, probes=probes,
                      topk=topk, expansion=expansion, dense=True,
                      q_layout=ql, df=d if ql else 0, ring=True,
                      sample=sample)
    return _granules(smem) <= _budget(SHAPES[DENSE, DENSE][1])


def slot_plan(layout: str, q_layout: str, num_tables: int, cap: int,
              n_modes: int, d: int, rq: int, rc: int, probes: int = 1,
              topk: int = 10, expansion: int = 0, df: int = 0,
              sample: bool = False) -> bool:
    """Whether a launch keeps its instantiation's row slots (``smem_bytes``'
    ``ring``): dense rows through the ring slots (``ring_plan``), TT rows
    of ranks 5-16 through ring slots (``TT_RING``: whole float4s of at most
    ``TT_RING_ROW`` floats) and ``<0, 16>``'s staged CP rows, each where the
    instantiation's target blocks fit beside the smallest window; otherwise
    the rows are read in place. The C launch tells the two plans apart by
    their shared bytes."""
    if layout == "dense":
        query = (q_layout, n_modes, d, rq) if q_layout != layout else None
        return ring_plan(num_tables, cap, df if query else d, probes, topk,
                         expansion, query, sample)
    tr_qr = instance(layout, q_layout, rq, rc, n_modes, d)
    if tr_qr in TT_RING:
        if not tt_ring_slot(n_modes * rc * d * rc):
            return False
    elif tr_qr != (0, 16):
        return False
    least = min(_pow2_ceil(num_tables * probes * cap), MIN_WINDOW)
    smem = smem_bytes(num_tables, n_modes, d, rq, rc, least,
                      tt=layout == "tt", probes=probes, topk=topk,
                      expansion=expansion, q_layout=q_layout, df=df,
                      ring=True, sample=sample)
    return _granules(smem) <= _budget(SHAPES[tr_qr][1])


def plan_blocks(smem: int, target: int) -> int:
    """The blocks per SM that a plan of ``smem`` shared bytes a block was
    sized for: the most, at most ``target``, whose budget holds it
    (``window_plan`` falls back to one block fewer when no window fits the
    target)."""
    return max((b for b in range(1, target + 1)
                if _granules(smem) <= _budget(b)), default=0)


def window_plan(num_tables: int, cap: int, n_modes: int, d: int, rq: int,
                rc: int, tt: bool = False, probes: int = 1, topk: int = 10,
                expansion: int = 0, dense: bool = False,
                q_layout: str | None = None, df: int = 0,
                ring: bool = False, sample: bool = False) -> tuple[int, bool]:
    """-> (window, scratch): the shared window's capacity in slots and
    whether a query can exceed it (L*T*cap above it, so the launch needs the
    global scratch). The capacity is the largest power of two in
    [MIN_WINDOW, MAX_WINDOW], and at most pow2(L*T*cap), with which the
    instantiation's target blocks (``SHAPES``) fit an SM's shared memory;
    failing that, with one block fewer. Raises ``ValueError`` when even one block
    cannot hold the query row, the candidate rows, the lists and the
    expansion beside the smallest window."""
    need = _pow2_ceil(num_tables * probes * cap)
    size = functools.partial(smem_bytes, num_tables, n_modes, d, rq, rc,
                             tt=tt, probes=probes, topk=topk,
                             expansion=expansion, dense=dense,
                             q_layout=q_layout, df=df, ring=ring,
                             sample=sample)
    least = min(need, MIN_WINDOW)
    layout = "tt" if tt else "dense" if dense else "cp"
    target = SHAPES[instance(layout, q_layout or layout, rq, rc, n_modes,
                             d)][1]
    for blocks in range(target, 0, -1):
        budget = _budget(blocks)
        window = min(need, MAX_WINDOW)
        while window >= least:
            if _granules(size(window)) <= budget:
                return window, need > window
            window //= 2
    raise ValueError(
        f"K1 needs {size(least)} B of shared memory for one query's rows, "
        f"top-k lists and expansion (N={n_modes}, d={d}, ranks {rq}, {rc}, "
        f"topk {topk}, {expansion} expansion candidates) beside a "
        f"{least}-slot window; one block holds {MAX_SMEM} B")


def probe_keys_from_values(values, offsets, mults, *, e2, w, num_tables,
                           num_codes, probes):
    """(B, L*K) raw values -> (L, T, B) ranked bucket keys (uint32 values
    in int64): discretize, combine, and the multi-probe expansion, as the
    reference's kernel runs them on its raw values."""
    codes, aux = probing.discretize_aux(values, offsets, e2=e2, w=w,
                                        num_tables=num_tables,
                                        num_codes=num_codes)
    u = codes.to(torch.int64) & _epi.U32_MASK
    mults = mults.to(torch.int64)
    base = _epi.mul_u32(u, mults).sum(-1) & _epi.U32_MASK    # (B, L)
    keys = probing.expand_keys(base, aux, mults, e2=e2, probes=probes)
    return keys.permute(1, 2, 0)


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on uint32 values held in int64 (the
    kernel's ``fmix32`` in uint32 arithmetic)."""
    h = h ^ (h >> 16)
    h = _epi.mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _epi.mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def noise_bits(key, rows: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """The sampling noise's uint32 hash of (key words, query row, effective
    id), int64 (B, W) for ``rows`` (B,) and ``eff`` (B, W): fmix32(r ^ eff)
    with r = fmix32(key[0] ^ fmix32(key[1] ^ row)), three rounds of
    murmur3's finalizer; a bijection of eff for a given row, so no two
    members of a row draw the same bits."""
    k0, k1 = (int(k) & _epi.U32_MASK for k in key)
    r = fmix32(k0 ^ fmix32(k1 ^ rows.to(torch.int64)))
    return fmix32(r[:, None] ^ eff.to(torch.int64))


def sample_key32(mode: str, h: torch.Tensor,
                 mult: torch.Tensor) -> torch.Tensor:
    """Members' uint32 sampling keys (int64), ascending = drawn first, from
    their ``noise_bits`` and raw hit counts: "uniform" ranks by the bits
    themselves (~h); "weighted" perturbs log(mult) by the Gumbel draw g =
    -log(-log(u)), u = ((h >> 9) + 0.5) 2^-23 (exact in fp32, inside (0,
    1)), and keys the perturbed logit descending (``order_key_bits`` of a
    similarity), all in fp32 as the kernel computes it."""
    if mode == "uniform":
        return (~h) & _epi.U32_MASK
    if mode != "weighted":
        raise ValueError(f"unknown sampling mode {mode!r}")
    u = (((h >> 9) << 1) | 1).to(torch.float32) * 2.0 ** -24
    g = -torch.log(-torch.log(u))
    pert = torch.log(mult.to(torch.float32)) + g
    return _epi.order_key_bits("cosine", pert)


def segment_windows(seg, keys, cap):
    """One segment's probe of (L, T, B) ``keys`` -> (cand (B, W) sorted
    local ids, valid (B, W) the first slot of each distinct live id): the
    raw windows of every (table, probe), ``dedup_windows``' sort and mask
    (the reference's ``probe_tables``)."""
    ids, hit = _epi.probe_windows(seg.sorted_keys, seg.perm, keys, cap,
                                  seg.live, seg.win)
    return _epi.dedup_windows(ids, hit, seg.sorted_keys.shape[1])


def segment_union(seg, keys, cap):
    """One segment's probed union from its raw windows -> (cand (B, W)
    sorted local ids, valid (B, W) the first slot of each distinct live id,
    mult (B, W) int64 its raw hit count over the (table, probe) windows,
    repeated base keys of the pad regime included): ``segment_windows``,
    then run lengths, as the reference's ``_sample_topk`` takes them."""
    cand, valid = segment_windows(seg, keys, cap)
    run = cand.to(torch.int64).contiguous()
    mult = (torch.searchsorted(run, run, right=True)
            - torch.searchsorted(run, run))
    return cand, valid, mult


def _unions(keys, segs, caps):
    """Every segment's ``segment_union`` -> (per segment (segment arrays,
    safe local ids (misses at 0)), and the segments' (eff, mult, valid)
    concatenated)."""
    parts, effs, mults, valids = [], [], [], []
    for seg, cap in zip(segs, caps):
        cand, valid, mult = segment_union(seg, keys, cap)
        safe = torch.where(valid, cand, 0).long()
        parts.append((seg, safe))
        effs.append(seg.eff[safe])
        mults.append(mult)
        valids.append(valid)
    return parts, (torch.cat(effs, 1), torch.cat(mults, 1),
                   torch.cat(valids, 1))


def sample_union(values, offsets, mults, segs, *, kind, w, num_tables,
                 num_codes, caps, probes=1):
    """The probed union of every query over ``segs`` -> (eff (B, W) int32
    effective ids, mult (B, W) int64 raw hit counts, valid (B, W)), the
    segments concatenated (arguments as ``fused_query_plain``): what the
    sampling modes draw from."""
    keys = probe_keys_from_values(values, offsets, mults,
                                  e2=kind.endswith("e2lsh"), w=w,
                                  num_tables=num_tables, num_codes=num_codes,
                                  probes=probes)
    return _unions(keys, segs, caps)[1]


def _plain_sample(keys, queries, segs, *, metric, topk, caps, mode, key):
    """The sampling modes' plain body: every segment's union, its members
    scored exactly (``hoisted_scores``) and keyed by ``sample_key32`` of
    their effective ids, the first ``topk`` by (key, effective id) drawn,
    then presented as ``packed_select`` presents the top-k."""
    parts, (eff, mult, valid) = _unions(keys, segs, caps)
    score = torch.cat([_seg.hoisted_scores(metric, queries[0], seg.corpus,
                                           safe) for seg, safe in parts], 1)
    rows = torch.arange(eff.shape[0], device=eff.device)
    k32 = sample_key32(mode, noise_bits(key, rows, eff), mult)
    hi = torch.where(valid, k32, _epi.PROBE_PAD_KEY)
    lo = torch.where(valid, eff, _epi.PROBE_PAD_ID).to(torch.int64)
    order = torch.argsort((hi - (1 << 31)) * (1 << 32) + lo, dim=1)
    order = order[:, :topk]
    hi, lo = _epi.pack_candidates(metric, eff.gather(1, order),
                                  score.gather(1, order),
                                  valid.gather(1, order))
    out_ids, out_scores = _epi.packed_select(metric, topk, hi, lo)
    return out_ids, out_scores, valid.sum(dim=1, dtype=torch.int32)


def _plain(values, offsets, mults, queries, segs, *, kind, w, num_tables,
           num_codes, metric, topk, caps, probes, mode="topk", key=None):
    """The body of K1's and K1s's plain versions."""
    keys = probe_keys_from_values(values, offsets, mults,
                                  e2=kind.endswith("e2lsh"), w=w,
                                  num_tables=num_tables, num_codes=num_codes,
                                  probes=probes)
    if mode != "topk":
        return _plain_sample(keys, queries, segs, metric=metric, topk=topk,
                             caps=caps, mode=mode, key=key)
    his, los = [], []
    n_cand = torch.zeros(values.shape[0], dtype=torch.int32,
                         device=values.device)
    for seg, cap in zip(segs, caps):
        cand, valid = segment_windows(seg, keys, cap)
        safe = torch.where(valid, cand, 0).long()
        scores = _seg.hoisted_scores(metric, queries[0], seg.corpus, safe)
        hi, lo = _epi.pack_candidates(metric, seg.eff[safe], scores, valid)
        his.append(hi)
        los.append(lo)
        n_cand += valid.sum(dim=1, dtype=torch.int32)
    out_ids, out_scores = _epi.packed_select(
        metric, topk, torch.cat(his, dim=1), torch.cat(los, dim=1))
    return out_ids, out_scores, n_cand


def sample_key_words(rng: torch.Generator) -> tuple[int, int]:
    """The two uint32 key words of one sampling call, drawn from ``rng``
    (on its own device): the only state the draw takes, so one generator
    state replays it."""
    words = torch.randint(0, 1 << 32, (2,), generator=rng,
                          dtype=torch.int64, device=rng.device)
    return tuple(int(x) for x in words.tolist())


def fused_query_plain(values, offsets, mults, queries, segs, *, kind, w,
                      num_tables, num_codes, metric, topk, caps, probes=1,
                      mode="topk", key=None):
    """Plain PyTorch version of K1 -> (ids (B, topk) int32 effective ids,
    scores (B, topk) float32, n_cand (B,) int32).

    values (B, L*K) float32 raw projections; offsets (L*K,) float32 (E2LSH;
    unused and may be None for SRP); mults (K,) uint32 values in int64;
    queries the (batched CP or TT tensor, stacked tensor) pair of the
    format's ``stack``; ``segs`` the segment arrays
    (``core.segments.SegmentArrays``) in slot-offset order and ``caps``
    their probe widths; ``probes`` = T. ``mode`` "uniform" / "weighted"
    draws ``topk`` distinct members of each query's probed union instead
    (``_plain_sample``), with ``key`` the two uint32 key words of the draw
    (``sample_key_words``); n_cand is the union's size either way.
    """
    fused_query_plain.calls += 1
    return _plain(values, offsets, mults, queries, segs, kind=kind, w=w,
                  num_tables=num_tables, num_codes=num_codes, metric=metric,
                  topk=topk, caps=caps, probes=probes, mode=mode, key=key)


fused_query_plain.calls = 0


def shard_segments(base, deltas, cap, delta_caps) -> tuple[tuple, tuple]:
    """A sharded store's (shard, segment) pairs in K1s's order, shard-major
    (shard 0's base slice and delta slabs, then shard 1's, ...: the
    reference's ``fused_query_sharded`` list) -> (per-shard segment arrays,
    their caps). ``base`` / ``deltas`` hold a leading shard dim."""
    segs, caps = [], []
    for s in range(base.sorted_keys.shape[0]):
        segs.append(base.shard(s))
        caps.append(cap)
        for d, dcap in zip(deltas, delta_caps):
            segs.append(d.shard(s))
            caps.append(dcap)
    return tuple(segs), tuple(caps)


def fused_query_sharded_plain(values, offsets, mults, queries, base, deltas,
                              *, kind, w, num_tables, num_codes, metric,
                              topk, cap, delta_caps, probes=1, mode="topk",
                              key=None):
    """Plain PyTorch version of K1s: ``fused_query_plain``'s body over
    ``shard_segments(base, deltas, cap, delta_caps)``, one flat packed
    selection over every (shard, segment) pair (other arguments as
    ``fused_query_plain``)."""
    fused_query_sharded_plain.calls += 1
    segs, caps = shard_segments(base, deltas, cap, delta_caps)
    return _plain(values, offsets, mults, queries, segs, kind=kind, w=w,
                  num_tables=num_tables, num_codes=num_codes, metric=metric,
                  topk=topk, caps=caps, probes=probes, mode=mode, key=key)


fused_query_sharded_plain.calls = 0


@dataclasses.dataclass(frozen=True)
class SegmentTable:
    """K1's view of a store's segments on the card: ``desc`` (G, 12) int64,
    one row per segment, or per (shard, segment) pair for K1s: pointers to
    sorted_keys, perm, live, eff, the stacked corpus, live_rank and
    live_pos (0 without a live window), then m, cap, the stacked corpus
    rank (1 for dense rows), the corpus scale's float64 bits and the floats
    of one stacked corpus row (prod d for dense rows). ``n_modes``, ``d``
    and ``rc`` are the format's ``kernel_shape`` of the stacked corpus (a
    dense row reads as one mode of prod d floats, rank 1). ``segs`` keeps the tensors
    the pointers name alive; ``scratch`` holds the launches' global
    scratch, one buffer per stream."""

    desc: torch.Tensor
    segs: tuple
    caps: tuple
    layout: str
    n_modes: int
    d: int
    rc: int
    # the global scratch of the queries whose window exceeds the shared one,
    # keyed by the launching stream's ``cuda_stream`` handle (None on the
    # CPU): two launches over one view on two streams (the scheduler's query
    # lane and a direct call from another thread) never share a hash set.
    # Each is {"slots": int32, per query a row of 3 * "scap" slots, a hash
    # set that is empty (-1) between launches and a candidate list;
    # SAMPLE_WORDS * "scap" for a sampling launch; "layout": the row's words
    # a window slot and "scap"} (``scratch_rows``)
    scratch: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)


def segment_table(segs, caps) -> SegmentTable | None:
    """Check the segments' arrays once and upload their K1 table (None for
    segments on the CPU, where the plain version reads the arrays)."""
    first = segs[0].stacked
    dev = first.device
    if dev.type != "cuda":
        return None
    layout = segs[0].corpus.layout
    shape_of = segs[0].corpus.kernel_shape
    n_modes, d, _ = shape_of(first)
    rows = []
    for seg, cap in zip(segs, caps):
        c = seg.stacked
        arrays = (seg.sorted_keys, seg.perm, seg.live, seg.eff, c)
        if seg.corpus.layout != layout or shape_of(c)[:2] != (n_modes, d):
            raise ValueError("a store's segments hold corpora of one layout "
                             "and mode shape")
        if tuple(a.dtype for a in arrays) != (
                torch.int64, torch.int32, torch.bool, torch.int32,
                torch.float32) or not all(a.is_contiguous() and a.device == dev
                                          for a in arrays):
            raise ValueError("K1 reads contiguous int64 sorted keys, int32 "
                             "perm, bool live, int32 eff and a float32 "
                             "stacked corpus on one card")
        rank_ptr = pos_ptr = 0
        if seg.win is not None:
            live_rank, live_pos = seg.win
            if (live_rank.dtype, live_pos.dtype) != (torch.int32,
                                                     torch.int32) or not (
                    live_rank.is_contiguous() and live_pos.is_contiguous()):
                raise ValueError("K1 reads contiguous int32 live-window "
                                 "lookups")
            rank_ptr, pos_ptr = live_rank.data_ptr(), live_pos.data_ptr()
        scale_bits = struct.unpack("<q", struct.pack(
            "<d", float(seg.corpus.scale)))[0]
        rows.append([a.data_ptr() for a in arrays[:4]]
                    + [c.data_ptr(), rank_ptr, pos_ptr,
                       seg.sorted_keys.shape[1], int(cap), shape_of(c)[2],
                       scale_bits, math.prod(c.shape[1:])])
    desc = torch.tensor(rows, dtype=torch.int64).to(dev)
    return SegmentTable(desc=desc, segs=tuple(segs), caps=tuple(caps),
                        layout=layout, n_modes=n_modes, d=d,
                        rc=max(shape_of(seg.stacked)[2] for seg in segs))


@functools.lru_cache(maxsize=None)
def _pairs(e2: bool, num_codes: int, device) -> torch.Tensor:
    """The expansion's static (a, b) pair indices, (P, 2) int32 on
    ``device``, uploaded once per (kind, K)."""
    pa, pb = probing.pair_indices(e2, num_codes)
    return torch.stack([torch.from_numpy(pa), torch.from_numpy(pb)],
                       dim=1).to(torch.int32).contiguous().to(device)


def scratch_rows(table: SegmentTable, b: int, scap: int, dev,
                 words: int = 3) -> torch.Tensor:
    """The global scratch of ``table`` laid out for a launch of ``b``
    queries at a row stride of ``words`` * ``scap`` slots (3, or
    ``SAMPLE_WORDS`` for a sampling launch), with every row's hash set (its
    first 2 * ``scap`` slots, 4 * ``scap`` for a sampling launch) empty.
    The kernel empties the slots it used, so a buffer of the same layout is
    reused as it is; a buffer laid out otherwise holds old candidate lists
    where the new hash sets lie, and is emptied first (``scap`` follows T
    and the caps, which a view's callers may change from one call to the
    next, and the mode). The buffer is the current stream's own
    (``stream_scratch``)."""
    mine = stream_scratch(table, dev)
    slots = mine.get("slots")
    if slots is None or slots.numel() < b * words * scap:
        slots = torch.full((b * words * scap,), -1, dtype=torch.int32,
                           device=dev)
    elif mine["layout"] != (words, scap):
        slots.fill_(-1)
    mine.update(slots=slots, layout=(words, scap))
    return slots


def stream_scratch(table: SegmentTable, dev) -> dict:
    """The current stream's entry of ``table.scratch`` (the CPU's, key
    None, where there are no streams), made empty on first use."""
    dev = torch.device(dev)
    key = (torch.cuda.current_stream(dev).cuda_stream
           if dev.type == "cuda" else None)
    return table.scratch.setdefault(key, {})


class BranchCounts(collections.Counter):
    """A K1 wrapper's launches by branch, and under "scratch" its queries
    that took the global scratch: the kernel adds those on the card, and
    reading "scratch" (or ``clear``) folds them in, one synchronizing read
    per card."""

    def __init__(self):
        super().__init__()
        self.on_card = {}   # device -> (1,) int64 queries not yet read

    def counter(self, dev) -> torch.Tensor:
        """The card's count of scratch queries that a launch adds to, made
        once (under the launch counts' lock, its zeros written before any
        stream's launch can add to it)."""
        with LOCK:
            if dev not in self.on_card:
                n = torch.zeros(1, dtype=torch.int64, device=dev)
                if n.device.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                self.on_card[dev] = n
        return self.on_card[dev]

    def _fold(self) -> None:
        for n in self.on_card.values():
            super().__setitem__("scratch",
                                super().__getitem__("scratch") + int(n))
            n.zero_()

    def __getitem__(self, key):
        if key == "scratch":
            self._fold()
        return super().__getitem__(key)

    def clear(self) -> None:
        self._fold()
        super().clear()


@dataclasses.dataclass(frozen=True)
class PairShape:
    """A query batch's shape against a K1 table: the queries' layout, the
    kernel's N and D (the CP or TT operand's modes and padded mode dim;
    (1, prod d) for a dense pair), the stacked query rank, the true mode
    dims and, for a cross-format pair with a dense side, their product
    ``df`` (0 otherwise)."""

    q_layout: str
    n_modes: int
    d: int
    rq: int
    dims: tuple
    df: int

    @property
    def same(self) -> bool:
        return self.df == 0


def pair_shape(table, queries) -> PairShape:
    """The ``PairShape`` of ``queries`` (the (format object, stacked) pair
    of the format's ``stack``) against ``table``; raises ``ValueError``
    when they do not fit (another mode shape, a non-contiguous or
    non-float32 stacked batch)."""
    x, q = queries
    corpus = table.segs[0].corpus
    ql = x.layout
    n, d, rq = x.kernel_shape(q)
    ok = (tuple(x.dims) == tuple(corpus.dims) and q.is_contiguous()
          and q.dtype == torch.float32)
    if ql == table.layout:
        ok = ok and q.dim() == table.segs[0].stacked.dim() and (
            (n, d) == (table.n_modes, table.d))
        df = 0
    else:
        df = math.prod(x.dims)
        if table.layout != "dense" and ql != "dense":
            ok = ok and (n, d) == (table.n_modes, table.d)
        elif table.layout != "dense":
            n, d = table.n_modes, table.d
    if not ok:
        raise ValueError(
            f"stacked queries {tuple(q.shape)} do not match the stacked "
            f"corpus {tuple(table.segs[0].stacked.shape)}")
    return PairShape(ql, n, d, rq, tuple(x.dims), df)


def launch_plan(table, rq: int, *, num_tables: int, probes: int, topk: int,
                expansion: int, pair: PairShape | None = None,
                sample: bool = False) -> tuple[int, bool, int]:
    """-> (window, scratch, shared bytes) of a launch over ``table`` with
    stacked query rank ``rq`` (``window_plan`` and ``smem_bytes``); a query
    batch of another layout gives its ``pair_shape`` as ``pair``, a
    sampling launch ``sample``."""
    n, d, q_layout, df = table.n_modes, table.d, None, 0
    if pair is not None and not pair.same:
        n, d, q_layout, df = pair.n_modes, pair.d, pair.q_layout, pair.df
    shape = SHAPES[instance(table.layout, q_layout or table.layout, rq,
                            table.rc, n, d)]
    return _plan(table.layout, num_tables, max(table.caps), n, d, rq,
                 table.rc, probes, topk, expansion, q_layout, df, shape,
                 sample)


@functools.lru_cache(maxsize=1024)
def _plan(layout, num_tables, cap, n, d, rq, rc, probes, topk, expansion,
          q_layout, df, shape, sample=False) -> tuple[int, bool, int]:
    """``launch_plan``'s work, once per distinct launch shape (``shape``,
    the instantiation's ``SHAPES`` entry, is part of the key, so a plan
    follows the table)."""
    kw = dict(tt=layout == "tt", dense=layout == "dense", probes=probes,
              topk=topk, expansion=expansion, q_layout=q_layout, df=df,
              sample=sample)
    kw["ring"] = slot_plan(layout, q_layout or layout, num_tables, cap, n, d,
                           rq, rc, probes, topk, expansion, df, sample)
    window, scratch = window_plan(num_tables, cap, n, d, rq, rc, **kw)
    return window, scratch, smem_bytes(num_tables, n, d, rq, rc, window,
                                       **kw)


def occupancy(table, rq: int, smem: int, q_layout: str | None = None,
              sample: bool = False) -> dict:
    """What the card makes of K1's instantiation for ``table`` (and queries
    of ``q_layout``, by default the corpus's; ``sample``: its sampling
    instantiation) at ``smem`` bytes of shared memory a block
    (``smem_bytes``, static scalars included): registers a thread, resident
    blocks per SM, local (spilled) bytes a thread and the target blocks per
    SM."""
    import ctypes

    from repro_torch.kernels import _build

    out = (ctypes.c_int * 4)()
    _build.check(_build.lib().fused_query_occupancy(
        FORMATS[table.layout], FORMATS[q_layout or table.layout], rq,
        table.rc, table.n_modes, table.d, int(sample), smem - STATIC_SMEM,
        ctypes.addressof(out)),
        "fused_query_occupancy")
    return dict(registers=out[0], blocks_per_sm=out[1], local_bytes=out[2],
                target_blocks=out[3])


@functools.lru_cache(maxsize=None)
def _dims(dims: tuple, d: int, device) -> torch.Tensor:
    """The mode dims, then their ``column_table`` for padded mode dim
    ``d``, as one int32 tensor on ``device``, uploaded once."""
    return torch.tensor(list(dims) + column_table(dims, d),
                        dtype=torch.int32, device=device)


def _check_device(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")


def _launch(values, offsets, mults, queries, table, *, kind, w, num_tables,
            num_codes, metric, topk, probes, counts, mode="topk", key=None):
    """One launch of ``csrc/fused_query.cu`` over the rows of ``table`` ->
    (ids, scores, n_cand, the branches it ran or None when B = 0 launched
    nothing); the queries that took the scratch add to ``counts``' count on
    the card. A sampling ``mode`` launches the instantiation's sampling
    twin (``csrc/fused_query_sample.cu``) with the draw's ``key`` words."""
    from repro_torch.kernels import _build

    dev = values.device
    if probes < 1:
        raise ValueError(f"probes must be >= 1, got {probes}")
    if mode not in MODES:
        raise ValueError(f"unknown query mode {mode!r}")
    sample = mode != "topk"
    if sample and key is None:
        raise ValueError(f"mode={mode!r} needs the draw's key words")
    k0, k1 = (int(k) & _epi.U32_MASK for k in key) if sample else (0, 0)
    e2 = kind.endswith("e2lsh")
    b = values.shape[0]
    q = queries[1]
    pair = pair_shape(table, queries)
    n, d, rq, rc = pair.n_modes, pair.d, pair.rq, table.rc
    if max([r for lay, r in ((table.layout, rc), (pair.q_layout, rq))
            if lay == "tt"], default=0) > MAX_TT_RANK:
        raise ValueError(f"K1 takes TT ranks up to {MAX_TT_RANK}; got "
                         f"Rq={rq}, Rc={rc}")
    # only a dense row is held to MAX_DENSE_ROW: a CP x TT pair sizes
    # nothing by its prod d
    dense_side = not pair.same and "dense" in (table.layout, pair.q_layout)
    row = (pair.df if dense_side
           else d if pair.same and table.layout == "dense" else 0)
    if row > MAX_DENSE_ROW:
        raise ValueError(f"K1 takes dense rows of up to {MAX_DENSE_ROW} "
                         f"floats (MAX_DENSE_ROW); got {row}")
    if dense_side and n > MAX_MODES:
        raise ValueError(f"K1 takes cross-format pairs with a dense side of "
                         f"up to {MAX_MODES} modes (MAX_MODES); got {n}")
    expansion = (probing.expansion_size(kind, num_codes) if probes > 1
                 else 0)
    window, need_scratch, smem = launch_plan(table, rq,
                                             num_tables=num_tables,
                                             probes=probes, topk=topk,
                                             expansion=expansion, pair=pair,
                                             sample=sample)
    vals = values.contiguous().float()
    offs = offsets.float().contiguous() if e2 else None
    mu = mults.to(dev, torch.int64).contiguous()
    pairs = _pairs(e2, num_codes, dev) if probes > 1 else None
    ids = torch.empty((b, topk), dtype=torch.int32, device=dev)
    scores = torch.empty((b, topk), dtype=torch.float32, device=dev)
    ncand = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return ids, scores, ncand, None
    # a query's row of the scratch: the hash set and the candidate list of
    # its largest window
    scap = _pow2_ceil(num_tables * probes * max(table.caps))
    scratch = (scratch_rows(table, b, scap, dev,
                            SAMPLE_WORDS if sample else 3)
               if need_scratch else None)
    # a CP or TT query's densified row over dense rows, past the staged one
    qscratch = (torch.empty((b, pair.df), dtype=torch.float32, device=dev)
                if table.layout == "dense" and pair.df > DENSE_STAGE
                else None)
    dims = _dims(pair.dims, d, dev) if dense_side else None
    tr_qr = instance(table.layout, pair.q_layout, rq, rc, n, d)
    threads, min_blocks, _, _ = SHAPES[tr_qr]
    with torch.cuda.device(dev):   # the launch goes to the tensors' card
        err = _build.lib().fused_query_launch(
            vals.data_ptr(), offs.data_ptr() if e2 else None, mu.data_ptr(),
            pairs.data_ptr() if pairs is not None else None, q.data_ptr(),
            table.desc.data_ptr(), len(table.segs), ids.data_ptr(),
            scores.data_ptr(), ncand.data_ptr(), b, num_tables, num_codes,
            probes, expansion, n, d, rq, rc, topk, int(e2),
            int(metric == "euclidean"), FORMATS[table.layout],
            FORMATS[pair.q_layout], float(w) if e2 else 1.0,
            float(queries[0].scale), window,
            scratch.data_ptr() if need_scratch else None, scap,
            counts.counter(dev).data_ptr(),
            qscratch.data_ptr() if qscratch is not None else None,
            dims.data_ptr() if dims is not None else None, pair.df,
            MODES[mode], k0, k1, threads, min_blocks, smem - STATIC_SMEM,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_query_launch")
    branches = [name for name, on in (
        ("multiprobe", probes > 1),
        ("live_window", any(s.win is not None for s in table.segs)),
        ("segments", len(table.segs) > 1),
        (f"mixed:{pair.q_layout}-{table.layout}", not pair.same),
        (f"sample:{mode}", sample),
        (("sample:" if sample else "k1:") + instance_name(*tr_qr), True))
        if on]
    return ids, scores, ncand, branches


def fused_query(values, offsets, mults, queries, segs, *, kind, w, num_tables,
                num_codes, metric, topk, caps, probes=1, table=None,
                mode="topk", key=None):
    """K1 on the tensors' device (arguments as ``fused_query_plain``;
    ``table`` the segments' ``segment_table``, built here if not given)."""
    dev = values.device
    probes = int(probes)
    if dev.type == "cpu":
        return fused_query_plain(values, offsets, mults, queries, segs,
                                 kind=kind, w=w, num_tables=num_tables,
                                 num_codes=num_codes, metric=metric,
                                 topk=topk, caps=caps, probes=probes,
                                 mode=mode, key=key)
    _check_device(dev, "fused_query")
    if table is None:
        table = segment_table(segs, caps)
    if tuple(caps) != table.caps or len(segs) != len(table.segs):
        raise ValueError("the K1 table was built for other segments")
    ids, scores, ncand, branches = _launch(
        values, offsets, mults, queries, table, kind=kind, w=w,
        num_tables=num_tables, num_codes=num_codes, metric=metric,
        topk=topk, probes=probes, counts=fused_query.branches, mode=mode,
        key=key)
    if branches is not None:
        count_launch(fused_query, branches)
    return ids, scores, ncand


counted(fused_query)
fused_query.branches = BranchCounts()


def fused_query_sharded(values, offsets, mults, queries, base, deltas, *,
                        kind, w, num_tables, num_codes, metric, topk, cap,
                        delta_caps, probes=1, table=None, mode="topk",
                        key=None):
    """K1s on the tensors' device: one launch of K1's kernel over every
    (shard, segment) pair (``shard_segments``' order) -> (ids (B, topk)
    int32 effective ids, scores (B, topk) float32, n_cand (B,) int32).
    ``base`` / ``deltas`` are the sharded segments' arrays (leading shard
    dim), ``cap`` / ``delta_caps`` their probe widths, ``table`` the
    pairs' ``segment_table`` (the store view's ``k1_table``), built here if
    not given; other arguments as ``fused_query_plain``."""
    dev = values.device
    probes = int(probes)
    kw = dict(kind=kind, w=w, num_tables=num_tables, num_codes=num_codes,
              metric=metric, topk=topk, mode=mode, key=key)
    if dev.type == "cpu":
        return fused_query_sharded_plain(values, offsets, mults, queries,
                                         base, deltas, cap=cap,
                                         delta_caps=delta_caps,
                                         probes=probes, **kw)
    _check_device(dev, "fused_query_sharded")
    if table is None:
        table = segment_table(*shard_segments(base, deltas, cap,
                                              delta_caps))
    caps = ((int(cap),) + tuple(delta_caps)) * base.sorted_keys.shape[0]
    if caps != table.caps:
        raise ValueError("the K1s table was built for other segments")
    ids, scores, ncand, branches = _launch(values, offsets, mults, queries,
                                           table, probes=probes,
                                           counts=fused_query_sharded.branches,
                                           **kw)
    if branches is not None:
        count_launch(fused_query_sharded, branches)
    return ids, scores, ncand


counted(fused_query_sharded)
fused_query_sharded.branches = BranchCounts()
