"""Sorted segments, the mutable segment store and the query planner
(reference: ``repro.core.segments``), single-device.

A segment is, per hash table, the bucket keys of its items sorted ascending,
the matching permutation of local item ids, and the corpus the ids point
into:

  ``TableSegment``  keys (m, L) in corpus order, sorted_keys (L, m), perm
                    (L, m) int32, the corpus (a batched CP or TT tensor),
                    the cap, and ``stacked``: the corpus in the kernels'
                    layout ((m, N, d, R) CP, (m, N, R, d, R) TT), whose
                    views the corpus factors or cores are.

Bucket keys are uint32 values held in int64. ``SegmentStore`` is one base
segment plus bounded delta segments (streaming inserts) and a host
tombstone mask (streaming deletes). Queries return *effective* ids, the
rank of an item among the live items in sequence (arrival) order, via a
host ``slot_pos`` map per segment. After every mutation the store derives,
per segment, the device lookups a query reads (``live`` (m+1,) bool with
entry m False, ``eff`` (m,) int32 and, for an explicit ``bucket_cap``, the
live-window lookups ``live_rank`` (L, m+1) / ``live_pos`` (L, m)) and
publishes them in one immutable ``StoreView``: once per mutation, never
once per query batch. The host bookkeeping stays numpy, as in the
reference.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import NamedTuple

import numpy as np
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
    win: tuple | None           # (live_rank (L, m+1), live_pos (L, m)) int32
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
    """Hash a query batch -> (L, B) bucket keys, or with ``probes`` = T > 1
    the (L, T, B) ranked multi-probe keys of ``core.probing`` (slot 0 the
    base key)."""
    from repro_torch.core import probing
    from repro_torch.kernels.ops import mults_tensor

    if probes == 1:
        return family.hash_keys(queries,
                                mults_tensor(mults, family.device)).T
    keys = probing.probe_keys(family, mults, queries, probes=probes)
    return keys.permute(1, 2, 0)                          # (B,L,T) -> (L,T,B)


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

    @property
    def items(self) -> int:     # every slot holds a real item
        return self.keys.shape[0]


def build_segment(keys: torch.Tensor, corpus, *,
                  bucket_cap: int | None = None,
                  warn_layout: str | None = None) -> TableSegment:
    """(m, L) corpus-order keys + CP or TT corpus -> sorted TableSegment.
    The cap is the largest bucket (exact candidate sets, with the
    coarse-family warning for base builds, ``warn_layout`` set) or
    min(``bucket_cap``, m). The corpus is stacked after the sort, so the
    sort's temporaries are freed before the stacked copy is made."""
    m = keys.shape[0]
    perm, sorted_keys, max_run = _sort_tables(keys.T.contiguous())
    if bucket_cap is None:
        cap = int(max_run) if m else 0
        if warn_layout is not None:
            _warn_coarse(warn_layout, cap, keys.shape[1], m)
    else:
        cap = min(int(bucket_cap), m)
    corpus, stacked = corpus.stack()
    return TableSegment(keys=keys, sorted_keys=sorted_keys, perm=perm,
                        corpus=corpus, cap=cap, stacked=stacked)


# ---------------------------------------------------------------------------
# Live-window lookups (explicit bucket_cap stores)
# ---------------------------------------------------------------------------


def _live_window_table(perm_l: torch.Tensor, live: torch.Tensor):
    """One table of ``_live_window_tables``: (rank (m+1,), pos (m,))
    int32."""
    live_sorted = live[perm_l.long()]                     # (m,) bool
    rank = torch.cat([torch.zeros(1, dtype=torch.int32, device=live.device),
                      torch.cumsum(live_sorted, 0, dtype=torch.int32)])
    pos = torch.argsort((~live_sorted).to(torch.uint8), stable=True)
    return rank, pos.to(torch.int32)


def _live_window_tables(perm: torch.Tensor, live: torch.Tensor):
    """(L, m) perm + (m+1,) live -> (live_rank (L, m+1), live_pos (L, m)).

    ``live_rank[p]`` counts the live slots among sorted positions [0, p) of
    the table; ``live_pos`` lists the live positions in ascending order,
    then the dead ones, also ascending. Built one table at a time, as in
    the reference."""
    outs = [_live_window_table(perm[t], live) for t in range(perm.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


# ---------------------------------------------------------------------------
# Mutable store: base + deltas + tombstones
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StoreView:
    """One immutable snapshot of a store's queryable state: a query reads
    ``store.view`` once and serves the whole batch from it. ``generation``
    increments with every publish; ``core.index`` uses it to refuse a
    shadow store whose source mutated while it was built. ``k1_table`` is
    K1's device table of the segments (``kernels.fused_query
    .segment_table``), built once per view."""

    segments: tuple          # base + deltas, slot-offset order
    luts: tuple              # per segment (live (m+1,), eff (m,))
    wins: tuple              # per segment live-window lookups (or None)
    generation: int = 0

    @property
    def base(self) -> TableSegment:
        return self.segments[0]

    @property
    def n_deltas(self) -> int:
        return len(self.segments) - 1

    def seg_arrays(self, i: int) -> SegmentArrays:
        seg = self.segments[i]
        live, eff = self.luts[i]
        return SegmentArrays(seg.corpus, seg.sorted_keys, seg.perm, live, eff,
                             self.wins[i], seg.stacked)

    @property
    def all_arrays(self) -> tuple:
        return tuple(self.seg_arrays(i) for i in range(len(self.segments)))

    @property
    def delta_arrays(self) -> tuple:
        return tuple(self.seg_arrays(i)
                     for i in range(1, len(self.segments)))

    @property
    def all_caps(self) -> tuple[int, ...]:
        return tuple(seg.cap for seg in self.segments)

    @property
    def delta_caps(self) -> tuple[int, ...]:
        return tuple(seg.cap for seg in self.segments[1:])

    @functools.cached_property
    def k1_table(self):
        from repro_torch.kernels.fused_query import segment_table
        return segment_table(self.all_arrays, self.all_caps)


def _cat_corpus(corpora):
    """Batched CP or TT tensors of one format, rank and scale -> one."""
    first = corpora[0]
    if len(corpora) == 1:
        return first
    if any(c.scale != first.scale for c in corpora):
        raise ValueError("segments of one store hold corpora of different "
                         "scales; they cannot be folded into one")
    return type(first)(tuple(torch.cat(ls) for ls in
                             zip(*(c.leaves for c in corpora))), first.scale)


class SegmentStore:
    """LSM-style mutable view over immutable segments (reference:
    ``repro.core.segments.SegmentStore``, single-device).

    One base ``TableSegment``, a list of delta segments, a host tombstone
    mask over every slot, and per segment a host ``slot_pos`` map from slot
    to sequence position. Every mutation ends by re-deriving the per-segment
    device lookups and publishing a fresh ``StoreView`` (one attribute
    write): ``live`` (m+1,) bool, ``eff`` (m,) int32 (the slot's effective
    id) and, with ``live_window``, the (live_rank, live_pos) tables.
    """

    def __init__(self, base: TableSegment, *, live_window: bool = False):
        self.base = base
        self.deltas: list[TableSegment] = []
        self.live_window = bool(live_window)
        self._generation = 0
        self.slot_pos = [np.arange(base.slots, dtype=np.int64)]
        self.live_host = np.ones(base.slots, bool)
        self.seq_len = int(base.items)
        self._refresh()

    @property
    def device(self) -> torch.device:
        return self.base.keys.device

    # -- derived state ------------------------------------------------------

    def _segments(self) -> list:
        return [self.base] + self.deltas

    def _seg_luts(self, live: np.ndarray, eff: np.ndarray):
        dev = self.device
        return (torch.from_numpy(np.append(live, False)).to(dev),
                torch.from_numpy(eff.astype(np.int32)).to(dev))

    def _seg_win(self, seg: TableSegment, live_lut: torch.Tensor):
        if not self.live_window:
            return None
        return _live_window_tables(seg.perm, live_lut)

    def _refresh(self, touched: set[int] | None = None) -> None:
        """Rebuild the sequence-order views and the segment lookups.

        ``touched`` is the set of segment indices whose live mask changed
        (None = all). Segments before the first touched one keep both
        lookups; later ones rebuild ``eff`` (ranks shift) but keep their
        live-window tables unless their own mask changed."""
        live_seq = np.zeros(self.seq_len, bool)
        pos_to_slot = np.full(self.seq_len, -1, np.int64)
        off = 0
        for pos, seg in zip(self.slot_pos, self._segments()):
            valid = pos >= 0
            live_seq[pos[valid]] = self.live_host[off:off + seg.slots][valid]
            pos_to_slot[pos[valid]] = off + np.flatnonzero(valid)
            off += seg.slots
        self._live_seq = live_seq
        self._pos_to_slot = pos_to_slot
        self.n_live = int(live_seq.sum())
        self.n_dead = self.seq_len - self.n_live
        eff_seq = (np.cumsum(live_seq) - 1).astype(np.int64)
        first = 0 if touched is None else min(touched, default=0)
        luts, wins, off = [], [], 0
        for i, (pos, seg) in enumerate(zip(self.slot_pos,
                                           self._segments())):
            if touched is not None and i < first:
                luts.append(self._luts[i])
                wins.append(self._wins[i])
                off += seg.slots
                continue
            live = self.live_host[off:off + seg.slots]
            eff = (eff_seq[np.clip(pos, 0, None)] if self.seq_len
                   else np.zeros(seg.slots, np.int64))
            eff = np.where(pos >= 0, eff, 0)
            lut = self._seg_luts(live, eff)
            luts.append(lut)
            if touched is None or i in touched:
                wins.append(self._seg_win(seg, lut[0]))
            else:
                wins.append(self._wins[i])
            off += seg.slots
        self._luts, self._wins = luts, wins
        self._publish()

    def _publish(self) -> None:
        """Assemble and install a fresh immutable view (one attribute
        write); on the card its K1 table is built here, not per query."""
        self._generation += 1
        view = StoreView(segments=tuple(self._segments()),
                         luts=tuple(self._luts), wins=tuple(self._wins),
                         generation=self._generation)
        if self.device.type == "cuda":
            _ = view.k1_table       # uploaded now, not by the next query
        self.view = view

    @property
    def generation(self) -> int:
        """Monotone mutation clock: bumps whenever a new view publishes."""
        return self.view.generation

    def seg_arrays(self, i: int) -> SegmentArrays:
        return self.view.seg_arrays(i)

    @property
    def mutated(self) -> bool:
        return bool(self.deltas) or self.n_dead > 0

    # -- durability hooks ----------------------------------------------------

    def host_state(self) -> dict:
        """The host bookkeeping a snapshot persists beside the segment
        arrays; everything else is re-derived by ``restore``."""
        return {
            "slot_pos": [np.asarray(p, np.int64) for p in self.slot_pos],
            "live_host": np.asarray(self.live_host, bool),
            "seq_len": int(self.seq_len),
            "live_window": bool(self.live_window),
        }

    @classmethod
    def restore(cls, segs, state: dict) -> "SegmentStore":
        """Rebuild a store from its segments + ``host_state()``, through
        ``_refresh`` (the path every mutation ends with)."""
        if len(segs) != len(state["slot_pos"]):
            raise ValueError(
                f"{len(segs)} segments but {len(state['slot_pos'])} "
                "slot_pos maps in the snapshot state")
        store = cls.__new__(cls)
        store.base = segs[0]
        store.deltas = list(segs[1:])
        store.live_window = bool(state["live_window"])
        store._generation = 0
        store.slot_pos = [np.asarray(p, np.int64) for p in state["slot_pos"]]
        store.live_host = np.asarray(state["live_host"], bool).copy()
        store.seq_len = int(state["seq_len"])
        store._refresh()
        return store

    # -- mutations ----------------------------------------------------------

    def append_delta(self, seg: TableSegment) -> None:
        """O(batch) append: the new items take the next sequence positions
        and effective ids (after every live item), so earlier segments'
        lookups are untouched and only the new segment's are built."""
        n_new = seg.slots
        seq0, slots0 = self.seq_len, self.live_host.size
        self.deltas.append(seg)
        self.slot_pos.append(np.arange(seq0, seq0 + n_new, dtype=np.int64))
        live = np.ones(n_new, bool)
        self.live_host = np.concatenate([self.live_host, live])
        self._live_seq = np.concatenate([self._live_seq, live])
        self._pos_to_slot = np.concatenate(
            [self._pos_to_slot, np.arange(slots0, slots0 + n_new)])
        eff = np.arange(self.n_live, self.n_live + n_new)
        self.seq_len += n_new
        self.n_live += n_new
        lut = self._seg_luts(live, eff)
        self._luts.append(lut)
        self._wins.append(self._seg_win(seg, lut[0]))
        self._publish()

    def delete_effective(self, ids) -> int:
        """Tombstone items by their current *effective* ids (the numbering
        queries return). Returns the number of newly dead items."""
        ids = np.unique(np.asarray(ids, np.int64))
        if ids.size == 0:
            return 0
        if ids[0] < 0 or ids[-1] >= self.n_live:
            raise IndexError(
                f"delete ids must be in [0, {self.n_live}), got "
                f"[{ids[0]}, {ids[-1]}]")
        seq_ids = np.flatnonzero(self._live_seq)[ids]
        slots = self._pos_to_slot[seq_ids]
        self.live_host[slots] = False
        bounds = np.cumsum([seg.slots for seg in self._segments()])
        touched = set(np.searchsorted(bounds, slots, side="right").tolist())
        self._refresh(touched)
        return int(ids.size)

    # -- effective (live) views --------------------------------------------

    def _live_slots_seq_order(self) -> np.ndarray:
        """Flat slot indices of the live items, in sequence order."""
        live_slots = np.flatnonzero(self.live_host)
        pos = np.concatenate(self.slot_pos)[live_slots]
        return live_slots[np.argsort(pos, kind="stable")]

    def effective_arrays(self):
        """-> ((n_live, L) keys, corpus) of the live items in sequence (=
        effective id) order, one gather each: the compaction input. Keys
        come from storage, never from re-hashing."""
        segs = self._segments()
        idx = torch.from_numpy(self._live_slots_seq_order()).to(self.device)
        keys = torch.cat([seg.keys for seg in segs])[idx]
        return keys, _cat_corpus([seg.corpus for seg in segs]).index(idx)

    def effective_corpus(self):
        """The live corpus in effective-id order: the base's own for a
        pristine store, a slice when the live slots are a prefix in
        sequence order, one gather otherwise."""
        if not self.mutated:
            return self.base.corpus
        corpus = _cat_corpus([seg.corpus for seg in self._segments()])
        idx = self._live_slots_seq_order()
        if np.array_equal(idx, np.arange(idx.size)):
            return corpus.index(slice(0, idx.size))
        return corpus.index(torch.from_numpy(idx).to(self.device))


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
                    topk: int, caps, probes: int = 1, table=None):
    """From a query batch to ((B, topk) effective ids, (B, topk) scores,
    (B,) candidate counts) over every segment (``segs`` in slot-offset
    order, ``caps`` their probe widths): the batch is stacked once, K3 or
    K4 (``raw`` epilogue) projects it, and one K1 launch expands each
    table's key to ``probes`` ranked keys, probes every segment and selects.
    ``table`` is the view's ``k1_table`` (built once per view on the
    card)."""
    from repro_torch.kernels.fused_query import fused_query
    from repro_torch.kernels.ops import mults_tensor

    family.check_inputs(queries)
    queries = queries.stack()
    values = family.raw_stacked(queries[1], queries[0].scale)
    return fused_query(values, family.offsets,
                       mults_tensor(mults, values.device), queries, segs,
                       kind=family.kind, w=family.bucket_width,
                       num_tables=family.num_tables,
                       num_codes=family.num_codes, metric=metric, topk=topk,
                       caps=caps, probes=probes, table=table)
