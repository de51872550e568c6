"""Sorted segments and the query planner (reference: ``repro.core.segments``),
single-device and immutable.

A segment is, per hash table, the bucket keys of its items sorted ascending,
the matching permutation of local item ids, and the corpus the ids point
into:

  ``TableSegment``  keys (m, L) in corpus order, sorted_keys (L, m), perm
                    (L, m) int32, the corpus (a batched CP or TT tensor),
                    the cap, and ``stacked``: the corpus in the kernels'
                    layout ((m, N, d, R) CP, (m, N, R, d, R) TT), whose
                    views the corpus factors or cores are.

Bucket keys are uint32 values held in int64. ``StoreView`` is the snapshot a
query reads; in this slice it holds the base segment only, with every slot
live and effective ids equal to slot ids, but it carries the (m+1,) ``live``
and (m,) ``eff`` lookups the reference's mutable store derives, so deltas
and tombstones can come later without a change to the query kernel.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import torch

from repro_torch.core.tensor_formats import CPTensor, TTTensor


class SegmentArrays(NamedTuple):
    """What a query reads of one segment (the reference's (corpus,
    sorted_keys, perm, live, eff, win) tuple, plus the stacked corpus the
    CUDA kernel reads)."""

    corpus: CPTensor | TTTensor
    sorted_keys: torch.Tensor   # (L, m) uint32 values in int64
    perm: torch.Tensor          # (L, m) int32
    live: torch.Tensor          # (m + 1,) bool, entry m False
    eff: torch.Tensor           # (m,) int32 effective ids
    win: tuple | None           # live-window lookups (queued: bucket_cap)
    stacked: torch.Tensor       # (m, N, d, R) CP / (m, N, R, d, R) TT


def bucket_keys(family, mults, corpus, batch_size: int) -> torch.Tensor:
    """(n, L) bucket keys of a CP or TT corpus, hashed in batches through
    ``family.hash_keys`` (K3 / K4 on the card)."""
    from repro_torch.kernels.ops import mults_tensor

    n = corpus.leaves[0].shape[0]
    mults = mults_tensor(mults, family.device)
    keys = [family.hash_keys(corpus.index(slice(s, min(s + batch_size, n))),
                             mults)
            for s in range(0, n, batch_size)]
    if not keys:
        return torch.empty((0, family.num_tables), dtype=torch.int64,
                           device=family.device)
    return torch.cat(keys, dim=0)


def query_keys(family, mults, queries,
               probes: int = 1) -> torch.Tensor:
    """Hash a query batch -> (L, B) bucket keys. Multi-probe (T > 1) is
    queued (ROADMAP.md)."""
    if probes != 1:
        raise NotImplementedError(
            "multi-probe query keys (probes > 1) are queued in ROADMAP.md")
    from repro_torch.kernels.ops import mults_tensor

    return family.hash_keys(queries, mults_tensor(mults, family.device)).T


def _max_run_length(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Longest run of equal values along the last axis of sorted keys."""
    flat = sorted_keys.reshape(-1, sorted_keys.shape[-1])
    n = flat.shape[1]
    if n == 0:
        return torch.tensor(0)
    idx = torch.arange(n, device=flat.device)
    new_run = torch.cat([torch.ones_like(flat[:, :1], dtype=torch.bool),
                         flat[:, 1:] != flat[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=1).values
    return (idx - run_start + 1).max()


def _sort_tables(keys_t: torch.Tensor):
    """(L, m) keys -> (perm int32, sorted_keys, max_run): a stable sort per
    table (the keys are non-negative, so the signed sort is the unsigned
    order)."""
    sorted_keys, perm = torch.sort(keys_t, dim=-1, stable=True)
    return perm.to(torch.int32), sorted_keys, _max_run_length(sorted_keys)


def _warn_coarse(layout: str, cap: int, num_tables: int, n: int) -> None:
    """The exact default cap would gather more candidates than the corpus
    holds: the family is too coarse for this data."""
    if not n or cap * num_tables <= n:
        return
    warnings.warn(
        f"{layout}: largest bucket has {cap} of {n} items, so the exact "
        f"default cap gathers up to L*cap={cap * num_tables} candidates per "
        "query (more than the corpus). The family is too coarse for this "
        "data; raise num_codes or shrink bucket_width.")


@dataclasses.dataclass(frozen=True)
class TableSegment:
    """One immutable sorted run (see the module docstring)."""

    keys: torch.Tensor          # (m, L) corpus order
    sorted_keys: torch.Tensor   # (L, m) ascending per table
    perm: torch.Tensor          # (L, m) int32 local ids in sorted-key order
    corpus: CPTensor | TTTensor  # batched, leaves (m, ...)
    cap: int                    # probe width: the largest bucket at build
    stacked: torch.Tensor       # the kernel layout of the corpus

    @property
    def slots(self) -> int:
        return self.keys.shape[0]


def build_segment(keys: torch.Tensor, corpus, *,
                  bucket_cap: int | None = None,
                  warn_layout: str | None = None) -> TableSegment:
    """(m, L) corpus-order keys + CP or TT corpus -> sorted TableSegment
    with the exact default cap (the largest bucket). The corpus is stacked
    after the sort, so the sort's temporaries are freed before the stacked
    copy is made."""
    if bucket_cap is not None:
        raise NotImplementedError(
            "an explicit bucket_cap (live-window probe) is queued in "
            "ROADMAP.md; this slice serves the exact default cap")
    m = keys.shape[0]
    perm, sorted_keys, max_run = _sort_tables(keys.T.contiguous())
    cap = int(max_run) if m else 0
    if warn_layout is not None:
        _warn_coarse(warn_layout, cap, keys.shape[1], m)
    corpus, stacked = corpus.stack()
    return TableSegment(keys=keys, sorted_keys=sorted_keys, perm=perm,
                        corpus=corpus, cap=cap, stacked=stacked)


@dataclasses.dataclass(frozen=True)
class StoreView:
    """The snapshot a query reads. Base segment only in this slice: every
    slot live, effective id = slot id."""

    segments: tuple
    luts: tuple                 # per segment (live (m+1,), eff (m,))
    wins: tuple

    @classmethod
    def base_only(cls, seg: TableSegment) -> "StoreView":
        m, dev = seg.slots, seg.keys.device
        live = torch.ones(m + 1, dtype=torch.bool, device=dev)
        live[m] = False
        eff = torch.arange(m, dtype=torch.int32, device=dev)
        return cls(segments=(seg,), luts=((live, eff),), wins=(None,))

    @property
    def base(self) -> TableSegment:
        return self.segments[0]

    def seg_arrays(self, i: int) -> SegmentArrays:
        seg = self.segments[i]
        live, eff = self.luts[i]
        return SegmentArrays(seg.corpus, seg.sorted_keys, seg.perm, live, eff,
                             self.wins[i], seg.stacked)

    @property
    def all_arrays(self) -> tuple:
        return tuple(self.seg_arrays(i) for i in range(len(self.segments)))

    @property
    def all_caps(self) -> tuple[int, ...]:
        return tuple(seg.cap for seg in self.segments)


# ---------------------------------------------------------------------------
# Re-rank and the query planner
# ---------------------------------------------------------------------------


def hoisted_scores(metric: str, queries, corpus, safe: torch.Tensor,
                   chunk: int = 64) -> torch.Tensor:
    """Exact re-rank scores of gathered candidates (``safe`` is the (B, W)
    clamped candidate matrix): <Y, Y> per corpus item once, <Q, Q> per query,
    <Q, Y> per (query, candidate), in format (CP Grams or the TT chain,
    ``chunk`` queries at a time so that the gathered (chunk, W) rows bound
    the memory), combined in the reference's expression and order:
    sqrt(max(qq + yy - 2 qy, 0)) or qy / (nq * ny)."""
    yy = corpus.self_inners()                             # (m,)
    qq = queries.self_inners()                            # (B,)
    qy = torch.cat([
        queries.index(slice(s, s + chunk)).index((slice(None), None))
        .pair_inners(corpus.index(safe[s:s + chunk]))
        for s in range(0, max(safe.shape[0], 1), chunk)], dim=0)  # (B, W)
    if metric == "euclidean":
        d2 = qq[:, None] + yy[safe] - 2.0 * qy
        return torch.sqrt(torch.clamp(d2, min=0.0))
    nq = torch.sqrt(torch.clamp(qq, min=0.0))
    ny = torch.sqrt(torch.clamp(yy, min=0.0))
    return qy / (nq[:, None] * ny[safe])


def segmented_query(family, segs, mults, queries, *, metric: str,
                    topk: int, caps, probes: int = 1):
    """From a query batch to ((B, topk) ids, (B, topk) scores, (B,)
    candidate counts): the batch is stacked once, K3 or K4 (``raw``
    epilogue) projects it and K1 probes the segment with it. One segment
    and T = 1 in this slice."""
    if probes != 1:
        raise NotImplementedError(
            "multi-probe queries (probes > 1) are queued in ROADMAP.md")
    if len(segs) != 1:
        raise NotImplementedError(
            "queries over several segments (delta segments) are queued in "
            "ROADMAP.md")
    from repro_torch.kernels.fused_query import fused_query
    from repro_torch.kernels.ops import mults_tensor

    family.check_inputs(queries)
    queries = queries.stack()
    values = family.raw_stacked(queries[1], queries[0].scale)
    return fused_query(values, family.offsets,
                       mults_tensor(mults, values.device), queries, segs[0],
                       kind=family.kind, w=family.bucket_width,
                       num_tables=family.num_tables,
                       num_codes=family.num_codes, metric=metric, topk=topk,
                       cap=caps[0])
