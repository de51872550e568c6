"""K1: one launch from a query batch's raw projections to (id, score) pairs
over every segment of a store (reference:
``repro.kernels.fused_query.fused_query``).

Stages, per query: discretize (E2LSH floor / SRP sign) -> uint32 radix
combine -> multi-probe expansion to T ranked keys per table -> per segment:
per-(table, probe) binary search over the sorted bucket keys, the dense
cap-wide window (bucket members, tombstones masked) or the live window
(the first ``cap`` live members, through ``live_rank`` / ``live_pos``),
sort-dedup, exact in-format re-rank, packed (order key, effective id) keys
-> top-k over all segments.

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

The probe window lives in shared memory while one block holds it (the
"shared" branch) and in per-query global scratch past that (the "spill"
branch, ``window_plan``): the same stages over the same window, so both
answer alike bit for bit.

``fused_query.launches`` / ``fused_query_sharded.launches`` count kernel
launches and ``.branches`` the launches that ran each branch
("multiprobe": T > 1, "live_window": a segment with live-window lookups,
"segments": more than one segment, "shared" / "spill": where the window
lives);
``fused_query_plain.calls`` / ``fused_query_sharded_plain.calls`` count
calls of the plain versions.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import struct

import torch

from repro_torch.core import probing
from repro_torch.core import segments as _seg
from repro_torch.kernels import epilogues as _epi

MAX_SMEM = 232_448         # bytes of shared memory one H100 block may use
THREADS = 256              # threads per query block (8 warps)
MAX_TT_RANK = 16           # largest TT rank K1's chains take
TABLE_COLS = 12            # int64 words per segment in the K1 table


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def smem_bytes(num_tables: int, n_modes: int, d: int, rq: int, rc: int,
               window: int, tt: bool = False, probes: int = 1,
               topk: int = 10, expansion: int = 0,
               spill: bool = False) -> int:
    """Shared memory of one K1 block (mirrors ``fused_query_smem_bytes`` in
    the CUDA source) for a window capacity ``window`` (a power of two): the
    running top-k and its merge buffer (16 bytes a rank), 8 + 4 bytes a
    window slot unless the window spills to global memory (the expansion's
    per-warp scores and deltas, ``expansion`` candidates of 8 bytes, reuse
    that region), the query's row, one candidate row per warp (CP factors
    (N, d, R) or TT cores (N, R, d, R) of ranks up to 8; rows of higher
    ranks are read in place) and, for TT, each warp's two chain states and
    their next values, four per-(table, probe) integer arrays, and 16 bytes
    of static scalars."""
    if tt:
        fq, fc = n_modes * rq * d * rq, n_modes * rc * d * rc
        sw = 2 * max(rq * rc + rc * rc, rq * rq)
        if max(rq, rc) > 8:
            fc = 0
    else:
        fq, fc, sw = n_modes * d * rq, n_modes * d * rc, 0
    nwarps = THREADS // 32
    region = nwarps * expansion * 8
    if not spill:
        region = max(window * 12, region)
    region = -(-region // 8) * 8
    lt = num_tables * probes
    return (16 * topk + region + (fq + nwarps * (fc + sw)) * 4
            + (4 * lt + 1) * 4 + 16)


def window_plan(num_tables: int, cap: int, n_modes: int, d: int, rq: int,
                rc: int, tt: bool = False, probes: int = 1, topk: int = 10,
                expansion: int = 0) -> tuple[int, str]:
    """-> (window, branch): the power-of-two window K1 sizes for the largest
    one segment needs (L*T*cap), and where it lives: "shared" while one
    block's shared memory holds it, else "spill" (per-query global
    scratch of window * 12 bytes). Raises ``ValueError`` when even the
    spill branch's shared part (the query row, the candidate rows, the
    expansion) exceeds a block."""
    window = _pow2_ceil(num_tables * probes * cap)
    size = functools.partial(smem_bytes, num_tables, n_modes, d, rq, rc,
                             window, tt=tt, probes=probes, topk=topk,
                             expansion=expansion)
    if size() <= MAX_SMEM:
        return window, "shared"
    if size(spill=True) <= MAX_SMEM:
        return window, "spill"
    raise ValueError(
        f"K1 needs {size(spill=True)} B of shared memory for one query's "
        f"rows and expansion (N={n_modes}, d={d}, ranks {rq}, {rc}, "
        f"{expansion} expansion candidates) beside a spilled window; one "
        f"block holds {MAX_SMEM} B")


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


def _plain(values, offsets, mults, queries, segs, *, kind, w, num_tables,
           num_codes, metric, topk, caps, probes):
    """The body of K1's and K1s's plain versions."""
    keys = probe_keys_from_values(values, offsets, mults,
                                  e2=kind.endswith("e2lsh"), w=w,
                                  num_tables=num_tables, num_codes=num_codes,
                                  probes=probes)
    his, los = [], []
    n_cand = torch.zeros(values.shape[0], dtype=torch.int32,
                         device=values.device)
    for seg, cap in zip(segs, caps):
        m = seg.sorted_keys.shape[1]
        ids, hit = _epi.probe_windows(seg.sorted_keys, seg.perm, keys, cap,
                                      seg.live, seg.win)
        cand, valid = _epi.dedup_windows(ids, hit, m)
        safe = torch.where(valid, cand, 0).long()
        scores = _seg.hoisted_scores(metric, queries[0], seg.corpus, safe)
        hi, lo = _epi.pack_candidates(metric, seg.eff[safe], scores, valid)
        his.append(hi)
        los.append(lo)
        n_cand += valid.sum(dim=1, dtype=torch.int32)
    out_ids, out_scores = _epi.packed_select(
        metric, topk, torch.cat(his, dim=1), torch.cat(los, dim=1))
    return out_ids, out_scores, n_cand


def fused_query_plain(values, offsets, mults, queries, segs, *, kind, w,
                      num_tables, num_codes, metric, topk, caps, probes=1):
    """Plain PyTorch version of K1 -> (ids (B, topk) int32 effective ids,
    scores (B, topk) float32, n_cand (B,) int32).

    values (B, L*K) float32 raw projections; offsets (L*K,) float32 (E2LSH;
    unused and may be None for SRP); mults (K,) uint32 values in int64;
    queries the (batched CP or TT tensor, stacked tensor) pair of the
    format's ``stack``; ``segs`` the segment arrays
    (``core.segments.SegmentArrays``) in slot-offset order and ``caps``
    their probe widths; ``probes`` = T.
    """
    fused_query_plain.calls += 1
    return _plain(values, offsets, mults, queries, segs, kind=kind, w=w,
                  num_tables=num_tables, num_codes=num_codes, metric=metric,
                  topk=topk, caps=caps, probes=probes)


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
                              topk, cap, delta_caps, probes=1):
    """Plain PyTorch version of K1s: ``fused_query_plain``'s body over
    ``shard_segments(base, deltas, cap, delta_caps)``, one flat packed
    selection over every (shard, segment) pair (other arguments as
    ``fused_query_plain``)."""
    fused_query_sharded_plain.calls += 1
    segs, caps = shard_segments(base, deltas, cap, delta_caps)
    return _plain(values, offsets, mults, queries, segs, kind=kind, w=w,
                  num_tables=num_tables, num_codes=num_codes, metric=metric,
                  topk=topk, caps=caps, probes=probes)


fused_query_sharded_plain.calls = 0


@dataclasses.dataclass(frozen=True)
class SegmentTable:
    """K1's view of a store's segments on the card: ``desc`` (G, 12) int64,
    one row per segment, or per (shard, segment) pair for K1s: pointers to
    sorted_keys, perm, live, eff, the stacked corpus, live_rank and
    live_pos (0 without a live window), then m, cap, the stacked corpus
    rank and the corpus scale's float64 bits. ``segs`` keeps the tensors
    the pointers name alive."""

    desc: torch.Tensor
    segs: tuple
    caps: tuple
    layout: str
    n_modes: int
    d: int
    rc: int


def segment_table(segs, caps) -> SegmentTable | None:
    """Check the segments' arrays once and upload their K1 table (None for
    segments on the CPU, where the plain version reads the arrays)."""
    first = segs[0].stacked
    dev = first.device
    if dev.type != "cuda":
        return None
    layout = segs[0].corpus.layout
    n_modes, d = first.shape[1], first.shape[-2]
    rows = []
    for seg, cap in zip(segs, caps):
        c = seg.stacked
        arrays = (seg.sorted_keys, seg.perm, seg.live, seg.eff, c)
        if seg.corpus.layout != layout or (c.shape[1], c.shape[-2]) != (
                n_modes, d):
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
                       seg.sorted_keys.shape[1], int(cap), c.shape[-1],
                       scale_bits, 0])
    desc = torch.tensor(rows, dtype=torch.int64).to(dev)
    return SegmentTable(desc=desc, segs=tuple(segs), caps=tuple(caps),
                        layout=layout, n_modes=n_modes, d=d,
                        rc=max(seg.stacked.shape[-1] for seg in segs))


@functools.lru_cache(maxsize=None)
def _pairs(e2: bool, num_codes: int, device) -> torch.Tensor:
    """The expansion's static (a, b) pair indices, (P, 2) int32 on
    ``device``, uploaded once per (kind, K)."""
    pa, pb = probing.pair_indices(e2, num_codes)
    return torch.stack([torch.from_numpy(pa), torch.from_numpy(pb)],
                       dim=1).to(torch.int32).contiguous().to(device)


def _check_device(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {dev}")


def _launch(values, offsets, mults, queries, table, *, kind, w, num_tables,
            num_codes, metric, topk, probes):
    """One launch of ``csrc/fused_query.cu`` over the rows of ``table`` ->
    (ids, scores, n_cand, the branches it ran or None when B = 0 launched
    nothing)."""
    from repro_torch.kernels import _build

    dev = values.device
    if probes < 1:
        raise ValueError(f"probes must be >= 1, got {probes}")
    e2 = kind.endswith("e2lsh")
    b = values.shape[0]
    q = queries[1]
    tt = table.layout == "tt"
    n, d, rc = table.n_modes, table.d, table.rc
    if (q.dim() != table.segs[0].stacked.dim()
            or (q.shape[1], q.shape[-2]) != (n, d) or not q.is_contiguous()
            or q.dtype != torch.float32):
        raise ValueError(f"stacked queries {tuple(q.shape)} do not match the "
                         f"stacked corpus {tuple(table.segs[0].stacked.shape)}")
    rq = q.shape[-1]
    if tt and max(rq, rc) > MAX_TT_RANK:
        raise ValueError(f"K1 takes TT ranks up to {MAX_TT_RANK}; got "
                         f"Rq={rq}, Rc={rc}")
    expansion = (probing.expansion_size(kind, num_codes) if probes > 1
                 else 0)
    window, where = window_plan(num_tables, max(table.caps), n, d, rq, rc,
                                tt=tt, probes=probes, topk=topk,
                                expansion=expansion)
    vals = values.contiguous().float()
    offs = offsets.float().contiguous() if e2 else None
    mu = mults.to(dev, torch.int64).contiguous()
    pairs = _pairs(e2, num_codes, dev) if probes > 1 else None
    ids = torch.empty((b, topk), dtype=torch.int32, device=dev)
    scores = torch.empty((b, topk), dtype=torch.float32, device=dev)
    ncand = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return ids, scores, ncand, None
    # the spill branch's window: per query `window` int64 selection keys,
    # then `window` uint32 slots
    spill = (torch.empty((b, window * 3 // 2), dtype=torch.int64,
                         device=dev) if where == "spill" else None)
    err = _build.lib().fused_query_launch(
        vals.data_ptr(), offs.data_ptr() if e2 else None, mu.data_ptr(),
        pairs.data_ptr() if pairs is not None else None, q.data_ptr(),
        table.desc.data_ptr(), len(table.segs), ids.data_ptr(),
        scores.data_ptr(), ncand.data_ptr(), b, num_tables, num_codes,
        probes, expansion, n, d, rq, rc, topk, int(e2),
        int(metric == "euclidean"), int(tt), float(w) if e2 else 1.0,
        float(queries[0].scale), window,
        spill.data_ptr() if spill is not None else None, THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_query_launch")
    branches = [name for name, on in (
        ("multiprobe", probes > 1),
        ("live_window", any(s.win is not None for s in table.segs)),
        ("segments", len(table.segs) > 1)) if on] + [where]
    return ids, scores, ncand, branches


def fused_query(values, offsets, mults, queries, segs, *, kind, w, num_tables,
                num_codes, metric, topk, caps, probes=1, table=None):
    """K1 on the tensors' device (arguments as ``fused_query_plain``;
    ``table`` the segments' ``segment_table``, built here if not given)."""
    dev = values.device
    probes = int(probes)
    if dev.type == "cpu":
        return fused_query_plain(values, offsets, mults, queries, segs,
                                 kind=kind, w=w, num_tables=num_tables,
                                 num_codes=num_codes, metric=metric,
                                 topk=topk, caps=caps, probes=probes)
    _check_device(dev, "fused_query")
    if table is None:
        table = segment_table(segs, caps)
    if tuple(caps) != table.caps or len(segs) != len(table.segs):
        raise ValueError("the K1 table was built for other segments")
    ids, scores, ncand, branches = _launch(
        values, offsets, mults, queries, table, kind=kind, w=w,
        num_tables=num_tables, num_codes=num_codes, metric=metric,
        topk=topk, probes=probes)
    if branches is not None:
        fused_query.launches += 1
        fused_query.branches.update(branches)
    return ids, scores, ncand


fused_query.launches = 0
fused_query.branches = collections.Counter()


def fused_query_sharded(values, offsets, mults, queries, base, deltas, *,
                        kind, w, num_tables, num_codes, metric, topk, cap,
                        delta_caps, probes=1, table=None):
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
              metric=metric, topk=topk)
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
                                           table, probes=probes, **kw)
    if branches is not None:
        fused_query_sharded.launches += 1
        fused_query_sharded.branches.update(branches)
    return ids, scores, ncand


fused_query_sharded.launches = 0
fused_query_sharded.branches = collections.Counter()
