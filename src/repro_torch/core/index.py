"""The device-resident (K, L) LSH index with streaming mutations
(reference: ``repro.core.index``, single device).

``DeviceLSHIndex.build`` hashes a CP or TT corpus in batches through K3
(CP) or K4 (TT) (``segments.bucket_keys``), sorts each table once and keeps
a ``SegmentStore``: the immutable base segment, delta segments and a
tombstone mask. ``insert`` hashes and sorts one delta segment, ``delete``
tombstones items by effective id, and ``compact`` (``prepare_compact`` +
``apply_swap``, a double-buffered swap) folds the stored keys of the live
items into a new base without re-hashing; more than ``max_deltas``
outstanding deltas compact automatically. ``query_batch`` runs K3 / K4
(``raw``) and one K1 launch over every segment, with ``probes`` = T ranked
keys per table. An explicit ``bucket_cap`` truncates buckets and keeps the
live-window lookups, so deletes never starve a truncated window.
Everything lives on the index's ``device`` ("cuda" unless the caller asks
for the CPU, where the kernels' plain versions run).

The sampling query modes, the sharded index and the host index are queued
(ROADMAP.md). The reference's ``swap_chunk_rows`` and ``probe_backend``
have no counterpart: the shadow store is gathered in one pass (the chunked,
throttled build waits for the scheduler's second stream) and the tensors'
device picks kernel or plain path.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import segments
from repro_torch.core.lsh import LSHFamily, make_mults
from repro_torch.core.probing import QUERY_MODES
from repro_torch.core.segments import (SegmentStore, bucket_keys,
                                       build_segment)
from repro_torch.kernels.ops import mults_tensor


def _check_metric(metric: str) -> None:
    if metric not in ("euclidean", "cosine"):
        raise ValueError(metric)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class PendingSwap:
    """A fully built shadow store awaiting publication (the second buffer
    of the double-buffered swap). ``source`` / ``generation`` pin the store
    state it was derived from, so a swap never silently drops mutations
    that landed while it was built."""

    store: SegmentStore
    source: SegmentStore
    generation: int


@dataclasses.dataclass
class DeviceLSHIndex:
    """Device-resident (K, L) index over a batched CP or TT corpus (the
    family's format); ``query_batch`` returns (ids (B, topk) int32
    effective ids with -1 fill, scores (B, topk) float32 with +inf / -inf
    fill, n_candidates (B,) int32) on the family's device."""

    family: LSHFamily
    metric: str = "euclidean"  # or "cosine"
    seed: int = 0
    bucket_cap: int | None = None  # None -> exact (largest build-time bucket)
    max_deltas: int = 8            # outstanding deltas before auto-compact

    store: SegmentStore | None = None
    compactions: int = 0
    auto_compactions: int = 0
    auto_compact_s: float = 0.0
    hash_s: float = 0.0        # build time in the K3 / K4 hash, synchronized
    sort_s: float = 0.0        # build time in the table sort, synchronized
    # the last insert's (hash, sort, lookups) seconds, synchronized
    insert_s: tuple = (0.0, 0.0, 0.0)

    def __post_init__(self):
        _check_metric(self.metric)
        self._mults = make_mults(self.seed, self.family.num_codes)
        self._mults_t = mults_tensor(self._mults, self.device)

    @property
    def device(self) -> torch.device:
        return self.family.device

    @property
    def size(self) -> int:
        """Number of live (queryable) items."""
        return self.store.n_live if self.store is not None else 0

    @property
    def cap(self) -> int:
        return self.store.base.cap

    @property
    def sorted_keys(self) -> torch.Tensor:
        return self.store.base.sorted_keys

    @property
    def perm(self) -> torch.Tensor:
        return self.store.base.perm

    def effective_corpus(self):
        """The live corpus the returned ids index into."""
        return self.store.effective_corpus()

    # -- build --------------------------------------------------------------

    def _check_batch(self, batch) -> None:
        if batch.device != self.device:
            raise ValueError(f"items on {batch.device}, family on "
                             f"{self.device}")
        self.family.check_inputs(batch)

    def _new_store(self, keys, corpus, warn: bool = True) -> SegmentStore:
        return SegmentStore(
            build_segment(keys, corpus, bucket_cap=self.bucket_cap,
                          warn_layout=type(self).__name__ if warn else None),
            live_window=self.bucket_cap is not None)

    def build(self, corpus, batch_size: int = 65536) -> "DeviceLSHIndex":
        """Hash ``corpus`` in batches of ``batch_size`` and sort the tables.
        Keys do not depend on the batch size; 65536 items per hash launch
        keep the card busy (the reference hashes 2048 at a time)."""
        self._check_batch(corpus)
        _sync(self.device)
        t0 = time.perf_counter()
        keys = bucket_keys(self.family, self._mults_t, corpus, batch_size)
        _sync(self.device)
        t1 = time.perf_counter()
        self.store = self._new_store(keys, corpus)
        _sync(self.device)
        self.hash_s, self.sort_s = t1 - t0, time.perf_counter() - t1
        self._reset_mutation_state()
        return self

    # -- mutations ----------------------------------------------------------

    def insert(self, batch, batch_size: int = 1024) -> "DeviceLSHIndex":
        """Append a batch of items as one sorted delta segment, served by
        the next query. New items take the next effective ids. More than
        ``max_deltas`` outstanding deltas compact automatically."""
        if batch.leaves[0].shape[0] == 0:
            return self
        self._check_batch(batch)
        _sync(self.device)
        t0 = time.perf_counter()
        keys = bucket_keys(self.family, self._mults_t, batch, batch_size)
        _sync(self.device)
        t1 = time.perf_counter()
        seg = build_segment(keys, batch, bucket_cap=self.bucket_cap)
        _sync(self.device)
        t2 = time.perf_counter()
        self.store.append_delta(seg)
        _sync(self.device)
        self.insert_s = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        self._maybe_auto_compact()
        return self

    def delete(self, ids) -> int:
        """Tombstone items by their current effective ids (the numbering
        ``query_batch`` returns). Later items shift down, exactly as in a
        fresh rebuild without them. Returns the number deleted."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        return self.store.delete_effective(np.asarray(ids))

    def _maybe_auto_compact(self) -> None:
        """Compact when the delta count exceeds ``max_deltas``; the fold's
        wall time goes to ``auto_compact_s`` / ``auto_compactions``."""
        if len(self.store.deltas) <= self.max_deltas:
            return
        t0 = time.perf_counter()
        self.compact()
        _sync(self.device)
        self.auto_compact_s += time.perf_counter() - t0
        self.auto_compactions += 1

    def _reset_mutation_state(self) -> None:
        """A rebuild starts a fresh mutation history."""
        self.compactions = 0
        self.auto_compactions = 0
        self.auto_compact_s = 0.0

    # -- double-buffered swap -----------------------------------------------

    def _build_compact_store(self, store: SegmentStore) -> SegmentStore:
        keys, corpus = store.effective_arrays()
        return self._new_store(keys, corpus, warn=False)

    def prepare_compact(self) -> PendingSwap | None:
        """Build the compacted replacement store off the query path: the
        stored keys of every live item (no re-hash), sorted anew, with its
        lookups; synchronizes the card before it returns. None when the
        store is pristine."""
        store = self.store
        if not store.mutated:
            return None
        if store.n_live == 0:
            raise ValueError("cannot compact an index with no live items")
        shadow = self._build_compact_store(store)
        _sync(self.device)
        return PendingSwap(store=shadow, source=store,
                           generation=store.generation)

    def apply_swap(self, pending: PendingSwap | None) -> "DeviceLSHIndex":
        """Publish a prepared shadow store: one attribute write, no device
        work. Raises RuntimeError if the live store mutated after
        ``pending`` was prepared."""
        if pending is None:
            return self
        store = self.store
        if (store is not pending.source
                or store.generation != pending.generation):
            raise RuntimeError(
                "store mutated since this swap was prepared; the shadow "
                "store is stale: call prepare again (serialize mutations "
                "with the prepare/apply pair)")
        self.store = pending.store      # the flip
        self.compactions += 1
        return self

    def compact(self) -> "DeviceLSHIndex":
        """Merge base + deltas minus tombstones into one fresh base segment
        (``prepare_compact`` then ``apply_swap``). Afterwards effective and
        physical ids coincide."""
        return self.apply_swap(self.prepare_compact())

    # -- query --------------------------------------------------------------

    def query_batch(self, queries, topk: int = 10, *,
                    probes: int = 1, mode: str = "topk", rng=None):
        """-> (ids (B, topk), scores (B, topk), n_candidates (B,)) tensors:
        K3 / K4 projects the batch, one K1 launch probes T = ``probes``
        ranked buckets per table of every segment, re-ranks and selects."""
        if mode not in QUERY_MODES:
            raise ValueError(
                f"unknown query mode {mode!r}; expected one of {QUERY_MODES}")
        if mode != "topk":
            raise NotImplementedError(
                f"mode={mode!r} (sampling from the probed union) is queued in "
                "ROADMAP.md")
        view = self.store.view
        return segments.segmented_query(
            self.family, view.all_arrays, self._mults_t, queries,
            metric=self.metric, topk=topk, caps=view.all_caps,
            probes=int(probes), table=view.k1_table)


# ---------------------------------------------------------------------------
# References / evaluation
# ---------------------------------------------------------------------------


def _score_matrix(metric: str, queries, corpus,
                  chunk: int | None = None) -> torch.Tensor:
    """(B, n) exact in-format scores, the corpus taken ``chunk`` items at a
    time (by default 2^21 floats of item rows, so that the (B, chunk) Grams
    or TT chain steps bound the memory)."""
    if chunk is None:
        chunk = max(1, (1 << 21) // corpus.row_floats)
    qq = queries.self_inners()
    qb = queries.index((slice(None), None))
    n = corpus.leaves[0].shape[0]
    out = []
    for s in range(0, n, chunk):
        part = corpus.index(slice(s, min(s + chunk, n)))
        yy = part.self_inners()
        qy = qb.pair_inners(part.index((None,)))
        if metric == "euclidean":
            d2 = qq[:, None] + yy[None] - 2.0 * qy
            out.append(torch.sqrt(torch.clamp(d2, min=0.0)))
        else:
            nq = torch.sqrt(torch.clamp(qq, min=0.0))
            ny = torch.sqrt(torch.clamp(yy, min=0.0))
            out.append(qy / (nq[:, None] * ny[None]))
    return torch.cat(out, dim=1)


def brute_force_batch(metric: str, queries, corpus, topk: int = 10):
    """Exact top-k over the whole corpus -> (ids (B, topk) int64 numpy,
    scores (B, topk) numpy); score ties resolve to the lower id."""
    _check_metric(metric)
    scores = _score_matrix(metric, queries, corpus)
    order = torch.argsort(scores if metric == "euclidean" else -scores,
                          dim=1, stable=True)[:, :topk]
    return (order.cpu().numpy(),
            torch.gather(scores, 1, order).cpu().numpy())


def recall_at_k(index, queries, topk: int = 10,
                probes: int = 1) -> dict[str, float]:
    """Mean recall@k of ``index.query_batch`` against brute force over the
    effective corpus."""
    truth, _ = brute_force_batch(index.metric, queries,
                                 index.effective_corpus(), topk)
    ids, _, n_cand = index.query_batch(queries, topk=topk, probes=probes)
    ids = ids.cpu().numpy()
    n_q = truth.shape[0]
    hits = sum(len(set(t) & set(row[row >= 0].tolist()))
               for t, row in zip(truth.tolist(), ids))
    return {
        "recall": hits / max(n_q * topk, 1),
        "mean_candidates": float(n_cand.sum().item()) / max(n_q, 1),
        "corpus_size": index.size,
    }
