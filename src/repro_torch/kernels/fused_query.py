"""K1: one launch from a query batch's raw projections to (id, score) pairs
(reference: ``repro.kernels.fused_query.fused_query``).

Stages, per query: discretize (E2LSH floor / SRP sign) -> uint32 radix
combine -> per-table binary search over the sorted bucket keys -> cap-wide
masked window gather -> sort-dedup -> exact in-format re-rank -> packed
(order key, effective id) top-k.

``fused_query`` launches the CUDA kernel ``csrc/fused_query.cu`` on CUDA
tensors and runs ``fused_query_plain`` on CPU tensors; any other device
raises. The plain version composes ``kernels.epilogues``' probe helpers and
``core.segments.hoisted_scores`` exactly as the reference's
``_fused_query_kernel`` does. Both take the raw projections as an input, so
the two can be held against each other on the same values
(``LSHFamily.raw_stacked`` makes them with K3 or K4 on the main path), and
both take the query batch as its format's ``stack`` gives it: the plain
version reads its per-mode views, the kernel the stacked tensor they view. The corpus and
the queries are CP (stacked (B, N, d, R)) or TT (stacked (B, N, R, d, R));
the re-rank is the format's inner product.

This slice covers the single-probe (T = 1), dense-window, one-segment
branch. The multi-probe expansion, the live-window (``bucket_cap``) branch,
several segments and the sharded entry are queued (ROADMAP.md).
``fused_query.launches`` counts kernel launches, ``fused_query_plain.calls``
calls of the plain version.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import segments as _seg
from repro_torch.kernels import epilogues as _epi

MAX_SMEM = 232_448         # bytes of shared memory one H100 block may use
THREADS = 256              # threads per query block (8 warps)
MAX_TT_RANK = 8            # largest TT rank K1's chain registers hold


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def smem_bytes(num_tables: int, n_modes: int, d: int, rq: int, rc: int,
               window: int, tt: bool = False) -> int:
    """Shared memory of one K1 block (mirrors ``fused_query_smem_bytes`` in
    the CUDA source) for a window capacity ``window`` (a power of two): 8 + 4
    bytes a slot, the query's row, one candidate row per warp (CP factors
    (N, d, R) or TT cores (N, R, d, R)) and, for TT, each warp's two chain
    states and their next values, three per-table integer arrays, and 8
    bytes of static scalars."""
    if tt:
        fq, fc = n_modes * rq * d * rq, n_modes * rc * d * rc
        sw = 2 * max(rq * rc + rc * rc, rq * rq)
    else:
        fq, fc, sw = n_modes * d * rq, n_modes * d * rc, 0
    return (window * 12 + fq * 4 + (THREADS // 32) * (fc + sw) * 4
            + (3 * num_tables + 1) * 4 + 8)


def window_capacity(num_tables: int, cap: int, n_modes: int, d: int,
                    rq: int, rc: int, tt: bool = False) -> int:
    """The power-of-two window K1 sizes its shared memory for; raises
    ``ValueError`` when L*cap exceeds the largest window one block holds."""
    window = _pow2_ceil(num_tables * cap)
    size = functools.partial(smem_bytes, num_tables, n_modes, d, rq, rc,
                             tt=tt)
    if size(window) > MAX_SMEM:
        largest = 1
        while size(2 * largest) <= MAX_SMEM:
            largest *= 2
        raise ValueError(
            f"K1 holds a probe window of at most {largest} slots in one "
            f"block's {MAX_SMEM} B of shared memory; L*cap = {num_tables}"
            f"*{cap} = {num_tables * cap} exceeds it. Raise num_codes or "
            "shrink bucket_width so buckets are smaller.")
    return window


def _discretize_keys(values, offsets, mults, *, e2, w, num_tables,
                     num_codes):
    """(B, L*K) raw values -> (L, B) uint32 bucket keys (int64)."""
    if e2:
        codes = torch.floor(_epi.div_w(values + offsets, w)).to(torch.int32)
    else:
        codes = (values > 0).to(torch.int32)
    codes = codes.reshape(values.shape[0], num_tables, num_codes)
    u = codes.to(torch.int64) & _epi.U32_MASK
    base = _epi.mul_u32(u, mults.to(torch.int64)).sum(-1) & _epi.U32_MASK
    return base.T


def fused_query_plain(values, offsets, mults, queries, seg, *, kind, w,
                      num_tables, num_codes, metric, topk, cap):
    """Plain PyTorch version of K1 -> (ids (B, topk) int32, scores
    (B, topk) float32, n_cand (B,) int32).

    values (B, L*K) float32 raw projections; offsets (L*K,) float32 (E2LSH;
    unused and may be None for SRP); mults (K,) uint32 values in int64;
    queries the (batched CP or TT tensor, stacked tensor) pair of the
    format's ``stack``; ``seg`` the segment arrays
    (``core.segments.SegmentArrays``).
    """
    fused_query_plain.calls += 1
    keys = _discretize_keys(values, offsets, mults, e2=kind.endswith("e2lsh"),
                            w=w, num_tables=num_tables, num_codes=num_codes)
    m = seg.sorted_keys.shape[1]
    ids, hit = _epi.probe_windows(seg.sorted_keys, seg.perm, keys, cap,
                                  seg.live, seg.win)
    cand, valid = _epi.dedup_windows(ids, hit, m)
    safe = torch.where(valid, cand, 0).long()
    scores = _seg.hoisted_scores(metric, queries[0], seg.corpus, safe)
    hi, lo = _epi.pack_candidates(metric, seg.eff[safe], scores, valid)
    out_ids, out_scores = _epi.packed_select(metric, topk, hi, lo)
    return out_ids, out_scores, valid.sum(dim=1, dtype=torch.int32)


fused_query_plain.calls = 0


def fused_query(values, offsets, mults, queries, seg, *, kind, w, num_tables,
                num_codes, metric, topk, cap):
    """K1 on the tensors' device (arguments as ``fused_query_plain``)."""
    dev = values.device
    if dev.type == "cpu":
        return fused_query_plain(values, offsets, mults, queries, seg,
                                 kind=kind, w=w, num_tables=num_tables,
                                 num_codes=num_codes, metric=metric,
                                 topk=topk, cap=cap)
    if dev.type != "cuda":
        raise ValueError(f"fused_query runs on cuda or cpu tensors, got {dev}")
    if seg.win is not None:
        raise NotImplementedError(
            "K1's live-window branch (bucket_cap) is queued in ROADMAP.md")
    from repro_torch.kernels import _build

    e2 = kind.endswith("e2lsh")
    b = values.shape[0]
    m = seg.sorted_keys.shape[1]
    c = seg.stacked
    q = queries[1]
    tt = seg.corpus.layout == "tt"        # (m, N, R, d, R); CP (m, N, d, R)
    n, d, rc = c.shape[1], c.shape[-2], c.shape[-1]
    if (q.dim() != c.dim() or (q.shape[1], q.shape[-2]) != (n, d)
            or not q.is_contiguous()):
        raise ValueError(f"stacked queries {tuple(q.shape)} do not match the "
                         f"stacked corpus {tuple(c.shape)}")
    rq = q.shape[-1]
    if tt and max(rq, rc) > MAX_TT_RANK:
        raise ValueError(f"K1 holds TT ranks up to {MAX_TT_RANK} in "
                         f"registers; got Rq={rq}, Rc={rc}")
    window = window_capacity(num_tables, cap, n, d, rq, rc, tt=tt)
    vals = values.contiguous().float()
    offs = offsets.float().contiguous() if e2 else None
    mu = mults.to(dev, torch.int64).contiguous()
    live = seg.live.contiguous()
    sorted_keys, perm = seg.sorted_keys.contiguous(), seg.perm.contiguous()
    eff = seg.eff.contiguous()
    if (q.dtype, c.dtype, sorted_keys.dtype, perm.dtype, live.dtype,
            eff.dtype) != (torch.float32, torch.float32, torch.int64,
                           torch.int32, torch.bool, torch.int32):
        raise ValueError("K1 reads float32 stacked queries and corpus, int64 "
                         "sorted keys, int32 perm, bool live, int32 eff")
    ids = torch.empty((b, topk), dtype=torch.int32, device=dev)
    scores = torch.empty((b, topk), dtype=torch.float32, device=dev)
    ncand = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return ids, scores, ncand
    qs, cs = float(queries[0].scale), float(seg.corpus.scale)
    err = _build.lib().fused_query_launch(
        vals.data_ptr(), offs.data_ptr() if e2 else None, mu.data_ptr(),
        q.data_ptr(), c.data_ptr(), sorted_keys.data_ptr(), perm.data_ptr(),
        live.data_ptr(), eff.data_ptr(), ids.data_ptr(),
        scores.data_ptr(), ncand.data_ptr(), b, num_tables, num_codes, n, d,
        rq, rc, m, cap, topk, int(e2), int(metric == "euclidean"), int(tt),
        float(w) if e2 else 1.0, qs * qs, qs * cs, cs * cs, window, THREADS,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_query_launch")
    fused_query.launches += 1
    return ids, scores, ncand


fused_query.launches = 0
