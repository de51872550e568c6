"""The device-resident (K, L) LSH indexes with streaming mutations
(reference: ``repro.core.index``), on one device; the sharded index
also over a mesh of devices.

A corpus, an insert batch or a query batch is a batched CP or TT tensor or
a plain (B, d_1, ..., d_N) dense tensor (wrapped once, ``as_batch``; the
effective corpus of a dense index comes back as a ``DenseTensor``, its
``data`` the rows). ``DeviceLSHIndex.build`` hashes the corpus in batches
(K3 for CP under CP, K4 for TT under TT, ``ops.dense_hash`` for the naive
kinds and dense inputs: ``segments.bucket_keys``), sorts each table once and keeps
a ``SegmentStore``: the immutable base segment, delta segments and a
tombstone mask. ``insert`` hashes and sorts one delta segment, ``delete``
tombstones items by effective id, and ``compact`` (``prepare_compact`` +
``apply_swap``, a double-buffered swap) folds the stored keys of the live
items into a new base without re-hashing; more than ``max_deltas``
outstanding deltas compact automatically. ``query_batch`` runs K3 / K4
(``raw``) and one K1 launch over every segment, with ``probes`` = T ranked
keys per table. An explicit ``bucket_cap`` truncates buckets and keeps the
live-window lookups, so deletes never starve a truncated window.

``ShardedLSHIndex`` keeps the same store over a ``ShardedSegment`` base:
S contiguous shards, each with its own sorted tables. ``insert`` routes a
batch least-loaded first (``segments.route_balanced``) into one sharded
delta slab, ``compact`` folds each shard's base slice, slabs and
tombstones shard-locally (no re-hash, no cross-shard move), and
``rebalance`` (``prepare_rebalance`` + ``apply_swap``) is the one
cross-shard move: it re-partitions the live corpus into the contiguous
layout of a fresh build. ``build`` resolves a mesh as the reference does
(``distributed.index_sharding.resolve_mesh``: an ``axis_rules`` context
whose ``lsh_shard`` axis has S slots, else the first S local devices of
the index's type). Without one every shard lives on the index's device
and ``query_batch`` runs one K1s launch over every (shard, segment) pair
(``query_path`` "vmap", the reference's single-program path). With one,
each shard's base block and slab blocks live on their slot's device, a
query hashes once, launches K1s once a slot and merges the S results
(``query_path`` "shard_map"): bit-equal to the one-device path. Routed
slabs, compaction and the lookups work a slot at a time on the slots'
devices; only ``rebalance`` moves items across them.

``_SegmentedIndex`` holds what the two share. Everything lives on the
index's ``device`` ("cuda" unless the caller asks for the CPU, where the
kernels' plain versions run). ``query_batch(..., mode="uniform" |
"weighted", rng=gen)`` samples ``topk`` distinct members of each query's
probed union instead (one K1 / K1s launch in sample mode); ``rng`` is a
``torch.Generator`` where the reference takes a PRNG key, and two uint32
key words drawn from it per call are the draw's only state.
``candidates_batch`` gives each query's candidate set (K1's keys, the
windows of K1's plain version), and ``query`` / ``candidates`` the
single-query forms of both (``_LSHIndexBase``, shared by every index).

``HostLSHIndex`` keeps the reference's dict-of-buckets build as the
bucket-membership reference: its ``candidates`` looks a query up in host
dicts, and its queries serve through the same K1 planner over a
single-segment store; it is rebuild-only. ``brute_force`` /
``brute_force_batch`` are the exact references. The reference's
``probe_backend`` has no counterpart: the tensors' device picks kernel or
plain path.

``swap_chunk_rows`` (default 4096, None for one pass) makes a compaction's
shadow build chunked and throttled (``segments.gather_rows_chunked``, the
tables sorted one at a time), bit-equal to the one-pass fold. Every
synchronization here is of the current stream, never of the whole card:
the serving scheduler runs mutations on its ingest lane's stream while its
query lane's kernels run on another. A query reads the store's view
through ``StoreView.acquire`` (the view's publication event, and its
arrays kept alive for the query's stream).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import contractions, segments
from repro_torch.core.lsh import LSHFamily, _combine_codes, make_mults
from repro_torch.core.probing import QUERY_MODES
from repro_torch.core.segments import (SegmentStore, bucket_keys,
                                       build_segment, build_sharded_segment)
from repro_torch.core.tensor_formats import as_batch, batch_of_one
from repro_torch.kernels.fused_query import sample_key_words
from repro_torch.kernels.ops import mults_tensor, unstack_like


def _check_metric(metric: str) -> None:
    if metric not in ("euclidean", "cosine"):
        raise ValueError(metric)


def _check_mode(mode: str, rng) -> None:
    """The reference's query-mode contract: the sampling modes need an
    explicit generator per request (no hidden state: the same generator
    state replays the draw), and the deterministic top-k mode refuses
    one."""
    if mode not in QUERY_MODES:
        raise ValueError(
            f"unknown query mode {mode!r}; expected one of {QUERY_MODES}")
    if mode == "topk" and rng is not None:
        raise ValueError("rng applies to the sampling modes only; "
                         "mode='topk' is deterministic")
    if mode != "topk" and rng is None:
        raise ValueError(
            f"mode={mode!r} samples from the probed bucket union and needs "
            "an explicit torch.Generator (pass "
            "rng=torch.Generator().manual_seed(seed))")


def _sync(device: torch.device) -> None:
    """Wait for the current stream (this lane's own work), not the card."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclasses.dataclass(frozen=True)
class PendingSwap:
    """A fully built shadow store awaiting publication (the second buffer
    of the double-buffered swap). ``source`` / ``generation`` pin the store
    state it was derived from, so a swap never silently drops mutations
    that landed while it was built. ``corpus_cache`` is what a sharded
    index's build-time corpus becomes at the flip."""

    store: SegmentStore
    kind: str                 # "compact" | "rebalance"
    source: SegmentStore
    generation: int
    corpus_cache: Any = None


class _LSHIndexBase:
    """The query API every index deployment shares (the reference's
    mixin): subclasses provide ``query_batch`` and ``candidates_batch``
    (the host index its own ``candidates``) and the ``family`` / ``metric``
    fields; the single-query wrappers below are the one implementation of
    the ``(ids, scores, n_candidates)`` numpy contract."""

    def __post_init__(self):
        _check_metric(self.metric)
        self._mults = make_mults(self.seed, self.family.num_codes)
        self._mults_t = mults_tensor(self._mults, self.device)

    @property
    def device(self) -> torch.device:
        return self.family.device

    def candidates(self, x, probes: int = 1) -> np.ndarray:
        """The distinct live members of one query's probed buckets over
        every table and segment, sorted (int64 effective ids); ``probes`` =
        T > 1 widens each table to its T ranked buckets."""
        cand, valid = self.candidates_batch(batch_of_one(x), probes=probes)
        cand = cand[0][valid[0]].cpu().numpy()
        return np.sort(cand).astype(np.int64)

    def query(self, x, topk: int = 10, *, probes: int = 1,
              mode: str = "topk", rng=None
              ) -> tuple[np.ndarray, np.ndarray, int]:
        """-> (ids, scores, n_candidates) of one query as numpy: the exact
        re-rank of its candidates (distances ascending for 'euclidean',
        similarities descending for 'cosine'), trimmed of the -1 fill.
        ``probes`` / ``mode`` / ``rng`` follow ``query_batch``."""
        ids, scores, n_cand = self.query_batch(batch_of_one(x), topk,
                                               probes=probes, mode=mode,
                                               rng=rng)
        ids, scores = ids[0].cpu().numpy(), scores[0].cpu().numpy()
        mask = ids >= 0
        return (ids[mask].astype(np.int64), scores[mask],
                int(n_cand[0].item()))

    def effective_corpus(self):
        """The corpus the returned ids index into (rebuild-only paths)."""
        return self.corpus


class _SegmentedIndex(_LSHIndexBase):
    """The store-backed mutation and introspection API that
    ``DeviceLSHIndex`` and ``ShardedLSHIndex`` share. Subclasses are
    dataclasses with the fields ``family``, ``metric``, ``seed``,
    ``bucket_cap``, ``max_deltas``, ``store`` and the counters, and
    implement ``_new_store``, ``_delta``, ``_build_compact_store``,
    ``_query`` and ``_candidates``."""

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

    @property
    def devices(self) -> tuple:
        """Every device the index's arrays lie on, its own first."""
        return (self.store.devices if self.store is not None
                else (self.device,))

    # -- build --------------------------------------------------------------

    def _check_batch(self, batch) -> None:
        if batch.device != self.device:
            raise ValueError(f"items on {batch.device}, family on "
                             f"{self.device}")
        self.family.check_inputs(batch)

    def build(self, corpus, batch_size: int = 65536):
        """Hash ``corpus`` in batches of ``batch_size`` and sort the tables.
        Keys do not depend on the batch size; 65536 items per hash launch
        keep the card busy (the reference hashes 2048 at a time)."""
        corpus = as_batch(corpus, len(self.family.projection.dims))
        self._check_batch(corpus)
        _sync(self.device)
        t0 = time.perf_counter()
        keys = bucket_keys(self.family, self._mults_t, corpus, batch_size)
        _sync(self.device)
        t1 = time.perf_counter()
        self.store = self._new_store(keys, corpus)
        segments.sync_devices(self.devices)
        self.hash_s, self.sort_s = t1 - t0, time.perf_counter() - t1
        self._reset_mutation_state()
        return self

    # -- mutations ----------------------------------------------------------

    def insert(self, batch, batch_size: int = 1024):
        """Append a batch of items as one sorted delta segment (a routed
        slab on the sharded index), served by the next query. New items
        take the next effective ids in batch order. More than
        ``max_deltas`` outstanding deltas compact automatically."""
        batch = as_batch(batch, len(self.family.projection.dims))
        if batch.leaves[0].shape[0] == 0:
            return self
        self._check_batch(batch)
        _sync(self.device)
        t0 = time.perf_counter()
        keys = bucket_keys(self.family, self._mults_t, batch, batch_size)
        _sync(self.device)
        t1 = time.perf_counter()
        seg, positions = self._delta(keys, batch)
        segments.sync_devices(self.devices)
        t2 = time.perf_counter()
        self.store.append_delta(seg, positions)
        segments.sync_devices(self.devices)
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
        segments.sync_devices(self.devices)
        self.auto_compact_s += time.perf_counter() - t0
        self.auto_compactions += 1

    def _reset_mutation_state(self) -> None:
        """A rebuild starts a fresh mutation history."""
        self.compactions = 0
        self.auto_compactions = 0
        self.auto_compact_s = 0.0

    # -- double-buffered swap -----------------------------------------------

    def prepare_compact(self) -> PendingSwap | None:
        """Build the compacted replacement store off the query path: the
        stored keys of every live item (no re-hash), sorted anew, with its
        lookups, chunked and throttled unless ``swap_chunk_rows`` is None;
        synchronizes its stream on every device of the shadow store before
        it returns, so the flip publishes a fully placed store. None when
        the store is pristine."""
        store = self.store
        if not store.mutated:
            return None
        if store.n_live == 0:
            raise ValueError("cannot compact an index with no live items")
        shadow = self._build_compact_store(store)
        segments.sync_devices(shadow.devices)
        return PendingSwap(store=shadow, kind="compact", source=store,
                           generation=store.generation)

    def apply_swap(self, pending: PendingSwap | None):
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
        self._pre_publish(pending)
        self.store = pending.store      # the flip
        if pending.kind == "compact":
            self.compactions += 1
        else:
            self.rebalances += 1
        return self

    def _pre_publish(self, pending: PendingSwap) -> None:
        """Subclass hook: index-side state that changes with the flip."""

    def compact(self):
        """Merge base + deltas minus tombstones into one fresh base segment
        (``prepare_compact`` then ``apply_swap``; shard-local on the
        sharded index). Effective ids, and so results, do not change."""
        return self.apply_swap(self.prepare_compact())

    # -- query --------------------------------------------------------------

    def candidates_batch(self, queries, *, probes: int = 1
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (cand (B, W) effective ids with -1 fill, valid (B, W) bool)
        on the index's device: every distinct live member of each query's
        probed buckets over every segment (every (shard, segment) pair),
        probed with the keys K1 probes, so each row's valid count equals
        ``query_batch``'s ``n_candidates``."""
        queries = as_batch(queries, len(self.family.projection.dims))
        return self._candidates(self.store.view.acquire(), queries,
                                int(probes))

    def query_batch(self, queries, topk: int = 10, *,
                    probes: int = 1, mode: str = "topk", rng=None):
        """-> (ids (B, topk) int32 effective ids with -1 fill, scores
        (B, topk) float32 with +inf / -inf fill, n_candidates (B,) int32)
        tensors on the index's device: K3 / K4 projects the batch and one
        K1 (K1s) launch probes T = ``probes`` ranked buckets per table of
        every segment (every (shard, segment) pair), re-ranks and
        selects. ``mode`` "uniform" / "weighted" instead samples ``topk``
        distinct members of each query's probed union (uniformly, or in
        proportion to how many probed windows hold them), with their exact
        scores, in the same order and fill; ``rng`` (a ``torch.Generator``)
        is required for them and refused for "topk"."""
        _check_mode(mode, rng)
        queries = as_batch(queries, len(self.family.projection.dims))
        key = None if mode == "topk" else sample_key_words(rng)
        return self._query(self.store.view.acquire(), queries, topk,
                           int(probes), mode, key)


@dataclasses.dataclass
class DeviceLSHIndex(_SegmentedIndex):
    """Device-resident (K, L) index over a batched CP or TT corpus (the
    family's format): one segment store, queried by one K1 launch."""

    family: LSHFamily
    metric: str = "euclidean"  # or "cosine"
    seed: int = 0
    bucket_cap: int | None = None  # None -> exact (largest build-time bucket)
    max_deltas: int = 8            # outstanding deltas before auto-compact
    swap_chunk_rows: int | None = 4096  # shadow-build copy chunk (None ->
                                        # one pass per fold)

    store: SegmentStore | None = None
    compactions: int = 0
    auto_compactions: int = 0
    auto_compact_s: float = 0.0
    hash_s: float = 0.0        # build time in the K3 / K4 hash, synchronized
    sort_s: float = 0.0        # build time in the table sort, synchronized
    # the last insert's (hash, sort, lookups) seconds, synchronized
    insert_s: tuple = (0.0, 0.0, 0.0)

    def _new_store(self, keys, corpus, warn: bool = True,
                   **kw) -> SegmentStore:
        return SegmentStore(
            build_segment(keys, corpus, bucket_cap=self.bucket_cap,
                          warn_layout=type(self).__name__ if warn else None,
                          **kw),
            live_window=self.bucket_cap is not None)

    def _delta(self, keys, batch):
        return build_segment(keys, batch, bucket_cap=self.bucket_cap), None

    def _build_compact_store(self, store: SegmentStore) -> SegmentStore:
        """The fold: one pass (``swap_chunk_rows`` None), or the corpus
        copied in bounded chunks straight into the kernels' layout and the
        tables sorted one at a time (the same arrays, bit for bit)."""
        if self.swap_chunk_rows is None:
            keys, corpus = store.effective_arrays()
            return self._new_store(keys, corpus, warn=False)
        keys, corpus, stacked = store.effective_arrays_chunked(
            int(self.swap_chunk_rows))
        return self._new_store(keys, corpus, warn=False, sort_throttled=True,
                               stacked=stacked)

    def _query(self, view, queries, topk, probes, mode, key):
        return _segmented_query(self, view, queries, topk, probes, mode,
                                key)

    def _candidates(self, view, queries, probes):
        return segments.segmented_candidates(
            self.family, view.all_arrays, self._mults_t, queries,
            caps=view.all_caps, probes=probes)


@dataclasses.dataclass
class ShardedLSHIndex(_SegmentedIndex):
    """Corpus-sharded (K, L) index: a ``ShardedSegment`` base of ``shards``
    contiguous slices, routed delta slabs, shard-local compaction and
    ``rebalance`` (see the module docstring), on the index's device or,
    with a mesh resolved at ``build``, each shard on its mesh slot's device
    (``mesh`` / ``mesh_axis``; ``query_path`` says which program runs).
    With the default exact cap its answers equal ``DeviceLSHIndex``'s for
    any shard count, any routing and any placement: K1 scores a candidate
    from its row and the query alone, whatever segment or card holds it.

    An explicit ``bucket_cap`` truncates each *shard's* slice of a bucket,
    so the union of candidates can exceed the single-device truncation (up
    to S*L*cap)."""

    family: LSHFamily
    metric: str = "euclidean"  # or "cosine"
    seed: int = 0
    shards: int = 1
    bucket_cap: int | None = None  # None -> exact (largest per-shard bucket)
    max_deltas: int = 8
    swap_chunk_rows: int | None = 4096  # shadow-build copy chunk (None ->
                                        # one pass per fold)
    keep_corpus: bool = True   # False drops the build-time corpus reference
                               # (``effective_corpus()`` regathers it)

    _corpus: Any = None        # the build-time corpus (keep_corpus=True)
    store: SegmentStore | None = None
    compactions: int = 0
    rebalances: int = 0
    auto_compactions: int = 0
    auto_compact_s: float = 0.0
    hash_s: float = 0.0
    sort_s: float = 0.0
    insert_s: tuple = (0.0, 0.0, 0.0)
    mesh: Any = None           # ``distributed.sharding.Mesh``, or None
    mesh_axis: str | None = None

    def __post_init__(self):
        if int(self.shards) < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        super().__post_init__()

    @property
    def query_path(self) -> str:
        """The program ``query_batch`` runs: "shard_map" (hash once, K1s
        once a mesh slot, the S-way merge) when a mesh carries the shard
        axis, "vmap" (one K1s launch over every pair on the index's
        device) without one: the reference's words."""
        return "shard_map" if self.mesh is not None else "vmap"

    def resolve_mesh(self) -> None:
        """Resolve ``mesh`` / ``mesh_axis`` for the index's shard count and
        device (``index_sharding.resolve_mesh``), as ``build`` and a
        recovery do; a mesh whose slots this process cannot use raises."""
        from repro_torch.distributed import index_sharding
        self.mesh, self.mesh_axis = index_sharding.resolve_mesh(
            int(self.shards), self.device)
        if self.mesh is not None:
            index_sharding.check_slots(self.mesh, self.mesh_axis, self.device)

    def _place_segment(self, seg, shadow: bool = False):
        """A one-device sharded segment laid over the mesh (the blocking
        ``place_shadow`` for a swap's shadow store), or as it is without
        one."""
        if self.mesh is None:
            return seg
        from repro_torch.distributed import index_sharding
        place = (index_sharding.place_shadow if shadow
                 else index_sharding.place_sharded)
        return place(seg, self.mesh, self.mesh_axis)

    @property
    def corpus(self):
        """The effective (live) corpus the returned ids index into: the
        build-time corpus while pristine (None under ``keep_corpus=False``),
        gathered from the segments once mutated. A shard-local compaction
        drops the build-time copy (shards no longer hold contiguous
        slices; the next read regathers and keeps it); a rebalance installs
        the gathered one."""
        if self.store is None:
            return self._corpus
        if self.store.mutated:
            return self.store.effective_corpus()
        if self._corpus is None and self.keep_corpus:
            self._corpus = self.store.effective_corpus()
        return self._corpus

    @property
    def corpus_sharded(self):
        """The base's (S, n_s, ...) zero-padded corpus (a mesh base's
        blocks gathered home, on demand)."""
        if not self.store:
            return None
        return segments.gather_blocks(self.store.base).corpus

    @property
    def shard_size(self) -> int:
        return self.store.base.shard_size

    def occupancy(self) -> np.ndarray:
        """(S,) live items per shard (base + delta slabs)."""
        return self.store.shard_live_counts

    def build(self, corpus, batch_size: int = 65536) -> "ShardedLSHIndex":
        corpus = as_batch(corpus, len(self.family.projection.dims))
        self.resolve_mesh()
        super().build(corpus, batch_size)
        self._corpus = corpus if self.keep_corpus else None
        return self

    def _reset_mutation_state(self) -> None:
        super()._reset_mutation_state()
        self.rebalances = 0

    def _new_store(self, keys, corpus, shadow: bool = False) -> SegmentStore:
        """The contiguous sharded build on the index's device, laid over
        the mesh when there is one (``shadow``: and waited for)."""
        seg = build_sharded_segment(keys, corpus, int(self.shards),
                                    bucket_cap=self.bucket_cap,
                                    warn_layout=type(self).__name__)
        return SegmentStore(self._place_segment(seg, shadow),
                            live_window=self.bucket_cap is not None)

    def _delta(self, keys, batch):
        """One routed slab: least-loaded shards first, contiguous runs of
        the batch, sorted per shard (on each slot's device where the store
        lies on a mesh)."""
        alloc, offsets = segments.route_balanced(
            keys.shape[0], self.store.shard_live_counts)
        return segments.build_sharded_delta(
            keys, batch, alloc, offsets, seq0=self.store.seq_len,
            bucket_cap=self.bucket_cap,
            devices=self.store.base.devices or None)

    def _build_compact_store(self, store: SegmentStore) -> SegmentStore:
        """The shard-local fold: each shard keeps its own live items (base
        slice + slabs, slot order = sequence order), stored keys only, one
        gather and sort per shard (``segments._slab_gather_sort``), or with
        ``swap_chunk_rows`` set the same values in bounded steps
        (``segments._slab_gather_sort_chunked``). Shards keep the item mix
        routing gave them; effective ids, and so results, do not change.
        On a mesh each slot folds its own blocks on its own device. The
        live store is untouched."""
        s = store.base.shards
        segs = store._segments()
        offs = np.cumsum([0] + [g.slots for g in segs[:-1]])
        live2d = np.concatenate(
            [store.live_host[off:off + g.slots].reshape(s, g.shard_size)
             for off, g in zip(offs, segs)], axis=1)
        pos2d = np.concatenate(
            [p.reshape(s, g.shard_size)
             for p, g in zip(store.slot_pos, segs)], axis=1)
        counts = live2d.sum(axis=1).astype(np.int64)
        new_ns = max(int(counts.max()), 1)
        w = live2d.shape[1]
        idx = np.full((s, new_ns), w, np.int64)
        new_pos = np.full((s, new_ns), -1, np.int64)
        eff_seq = np.cumsum(store._live_seq) - 1
        for sh in range(s):
            sel = np.flatnonzero(live2d[sh])    # slot order = seq order
            idx[sh, :sel.size] = sel
            new_pos[sh, :sel.size] = eff_seq[pos2d[sh, sel]]
        if store.base.blocks:
            # each slot folds its own blocks: the one-device fold's slice
            folds = [self._fold([g.blocks[sh] for g in segs],
                                idx[sh:sh + 1], counts[sh:sh + 1], new_ns)
                     for sh in range(s)]
            max_run = max(f.cap for f in folds)
        else:
            fold = self._fold(segs, idx, counts, new_ns)
            max_run = fold.cap
        if self.bucket_cap is None:
            cap = max(max_run, 1)
            segments._warn_coarse(type(self).__name__, cap,
                                  self.family.num_tables, int(counts.max()),
                                  shards=s)
        else:
            cap = min(int(self.bucket_cap), new_ns)
        if store.base.blocks:
            seg = segments.mesh_segment(folds, cap, store.device)
        else:
            seg = dataclasses.replace(fold, cap=cap)
        return SegmentStore(seg, base_pos=new_pos.reshape(-1),
                            live_window=self.bucket_cap is not None)

    def _fold(self, segs, idx: np.ndarray, counts: np.ndarray,
              new_ns: int) -> segments.ShardedSegment:
        """``_build_compact_store``'s gather and sort over one-device
        sharded segments ``segs`` (the store's, or one slot's blocks) on
        their device -> the folded segment, its ``cap`` the longest stored
        run for the caller to settle."""
        dev = segs[0].keys.device
        counts_t = torch.from_numpy(counts).to(dev)
        keys = [g.keys for g in segs]
        stacked = [g.stacked for g in segs]
        if self.swap_chunk_rows is None:
            keys_n, sorted_keys, perm, stacked, max_runs = \
                segments._slab_gather_sort(
                    keys, stacked, torch.from_numpy(idx).to(dev), counts_t,
                    shard_size=new_ns)
        else:
            keys_n, sorted_keys, perm, stacked, max_runs = \
                segments._slab_gather_sort_chunked(
                    keys, stacked, idx, counts_t, shard_size=new_ns,
                    chunk=int(self.swap_chunk_rows))
        return segments.ShardedSegment(
            keys=keys_n, sorted_keys=sorted_keys, perm=perm,
            corpus=unstack_like(segs[0].corpus, stacked),
            cap=int(max_runs.max()), counts=tuple(int(c) for c in counts),
            stacked=stacked)

    def _pre_publish(self, pending: PendingSwap) -> None:
        # a shard-local compaction leaves no contiguous build-time corpus
        # (corpus_cache None); a rebalance installs the gathered one
        self._corpus = pending.corpus_cache

    def prepare_rebalance(self) -> PendingSwap:
        """Build the re-partitioned replacement store off the query path:
        the live corpus and its stored keys gathered in sequence order,
        split into S contiguous shards and sorted per shard (the layout of
        a fresh build over ``effective_corpus()``), in one pass as in the
        reference; synchronizes its stream before it returns."""
        store = self.store
        if store.n_live == 0:
            raise ValueError("cannot rebalance an index with no live items")
        keys, corpus = store.effective_arrays()
        shadow = self._new_store(keys, corpus, shadow=True)
        segments.sync_devices(shadow.devices)
        return PendingSwap(store=shadow, kind="rebalance", source=store,
                           generation=store.generation,
                           corpus_cache=corpus if self.keep_corpus else None)

    def rebalance(self) -> "ShardedLSHIndex":
        """Re-partition the live corpus into S contiguous, evenly sized
        shards (``prepare_rebalance`` then ``apply_swap``): the only
        cross-shard move, for when routing skew or compaction history
        leaves occupancy uneven. Afterwards the index answers exactly as a
        fresh build over the effective corpus."""
        return self.apply_swap(self.prepare_rebalance())

    def _query(self, view, queries, topk, probes, mode, key):
        if view.slots:
            from repro_torch.distributed import index_sharding
            return index_sharding.shard_map_query(
                self.family, view, self._mults_t, queries,
                metric=self.metric, topk=topk, probes=probes, mode=mode,
                key=key)
        args = (self.family, view.seg_arrays(0), view.delta_arrays,
                self._mults_t, queries)
        kw = dict(metric=self.metric, topk=topk, cap=view.base.cap,
                  delta_caps=view.delta_caps, probes=probes,
                  table=view.k1_table)
        if mode != "topk":
            return segments.sharded_sample(*args, key, mode=mode, **kw)
        return segments.sharded_query(*args, **kw)

    def _candidates(self, view, queries, probes):
        if view.slots:
            from repro_torch.distributed import index_sharding
            return index_sharding.shard_map_candidates(
                self.family, view, self._mults_t, queries, probes=probes)
        return segments.sharded_candidates(
            self.family, view.seg_arrays(0), view.delta_arrays,
            self._mults_t, queries, cap=view.base.cap,
            delta_caps=view.delta_caps, probes=probes)


def _segmented_query(index, view, queries, topk, probes, mode, key):
    """A single-segment-list store's query (the device and host indexes):
    one K1 launch over every segment, or its sampling twin."""
    if mode != "topk":
        return segments.segmented_sample(
            index.family, view.all_arrays, index._mults_t, queries, key,
            metric=index.metric, topk=topk, caps=view.all_caps,
            probes=probes, mode=mode, table=view.k1_table)
    return segments.segmented_query(
        index.family, view.all_arrays, index._mults_t, queries,
        metric=index.metric, topk=topk, caps=view.all_caps, probes=probes,
        table=view.k1_table)


# ---------------------------------------------------------------------------
# Host index (the dict-of-buckets build, kept as the membership reference)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HostLSHIndex(_LSHIndexBase):
    """Dict-of-buckets build: the bucket-membership reference.

    ``build`` hashes the corpus through ``segments.bucket_keys`` (K3 / K4
    on the card), copies the keys to the host and fills one dict a table,
    bucket key -> the span of its members' ascending ids in the table's
    stable numpy sort of the keys (the reference appends item by item to a
    list a bucket: the same membership). ``candidates()`` looks one query
    up in the dicts; ``query`` / ``query_batch`` serve through the same
    planner as the device index (K1, or its sampling twin) over a
    single-segment store on the family's device. Rebuild-only: the
    streaming mutations live on the device and sharded indexes."""

    family: LSHFamily
    metric: str = "euclidean"  # or "cosine"
    seed: int = 0

    corpus: Any = None
    size: int = 0
    store: SegmentStore | None = None
    hash_s: float = 0.0        # build time in the hash, synchronized
    sort_s: float = 0.0        # build time in the segment's table sort
    dict_s: float = 0.0        # build time filling the host dicts
    _tables: list | None = None    # per table: bucket key -> (lo, hi)
    _members: list | None = None   # per table: ids in key order

    def build(self, corpus, batch_size: int = 65536) -> "HostLSHIndex":
        corpus = as_batch(corpus, len(self.family.projection.dims))
        if corpus.device != self.device:
            raise ValueError(f"items on {corpus.device}, family on "
                             f"{self.device}")
        self.family.check_inputs(corpus)
        self.corpus = corpus
        self.size = corpus.leaves[0].shape[0]
        _sync(self.device)
        t0 = time.perf_counter()
        keys = bucket_keys(self.family, self._mults_t, corpus, batch_size)
        all_keys = keys.cpu().numpy()
        t1 = time.perf_counter()
        self._tables, self._members = [], []
        for col in all_keys.T:
            order = np.argsort(col, kind="stable")
            sk = col[order]
            starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
            ends = np.r_[starts[1:], sk.size]
            self._tables.append(dict(zip(sk[starts].tolist(),
                                         zip(starts.tolist(),
                                             ends.tolist()))))
            self._members.append(order)
        t2 = time.perf_counter()
        self.store = SegmentStore(build_segment(
            keys, corpus, warn_layout=type(self).__name__))
        _sync(self.device)
        self.hash_s, self.dict_s = t1 - t0, t2 - t1
        self.sort_s = time.perf_counter() - t2
        return self

    def candidates(self, x, probes: int = 1) -> np.ndarray:
        """The union of one query's bucket members over the L tables, from
        the host dicts (sorted int64 ids). T = 1 looks up the key of
        ``family.hash(x)``; ``probes`` = T > 1 each table's T ranked keys,
        made from the hash path's raw values as K1 makes them
        (``segments.k1_probe_keys``), so that dict membership and K1's
        windows are held on the same keys."""
        t = int(probes)
        if t == 1:
            codes = self.family.hash(x)
            keys = _combine_codes(codes, self._mults_t)[:, None]  # (L, 1)
        else:
            keys = segments.k1_probe_keys(self.family, self._mults_t,
                                          batch_of_one(x), t)[:, :, 0]
        parts = []
        for table, members, row in zip(self._tables, self._members,
                                       keys.cpu().numpy().tolist()):
            for key in row:
                span = table.get(key)
                if span is not None:
                    parts.append(members[span[0]:span[1]])
        if not parts:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(parts)).astype(np.int64)

    def query_batch(self, queries, topk: int = 10, *, probes: int = 1,
                    mode: str = "topk", rng=None):
        """The device index's ``query_batch`` contract, over the host
        index's single-segment store."""
        _check_mode(mode, rng)
        queries = as_batch(queries, len(self.family.projection.dims))
        key = None if mode == "topk" else sample_key_words(rng)
        return _segmented_query(self, self.store.view.acquire(), queries,
                                topk, int(probes), mode, key)


# ---------------------------------------------------------------------------
# References / evaluation
# ---------------------------------------------------------------------------


def _cross_floats(queries, corpus) -> int:
    """Floats of the largest intermediate of one cross-format <Q, Y> (0 for
    a same-format pair): R * prod d / d_1 for a dense operand against CP or
    TT rows (the contraction's first step), R^ * d * r for CP x TT."""
    a, b = queries, corpus
    if a.layout == b.layout:
        return 0
    if "dense" in (a.layout, b.layout):
        dense, other = (a, b) if a.layout == "dense" else (b, a)
        return other.rank * dense.row_floats // dense.dims[0]
    return a.rank * b.rank * max(a.dims)


def _score_matrix(metric: str, queries, corpus,
                  chunk: int | None = None) -> torch.Tensor:
    """(B, n) exact scores, qq in the queries' format, yy in the corpus's and
    qy across the two (``contractions.pair_inners``). Each query row is
    scored on its own, a fresh contiguous copy of it against the corpus
    taken ``chunk`` items at a time (by default 2^26 floats of one item's
    rows and cross-format intermediate), so its bits do not depend on the
    batch it came in: the contractions' reductions (BLAS, cuBLAS) order
    their sums by the operands' shapes, and a batch folds its row count into
    them. yy is the corpus's alone, computed once a chunk."""
    n = corpus.leaves[0].shape[0]
    if chunk is None:
        per_item = corpus.row_floats + _cross_floats(queries, corpus)
        chunk = max(1, (1 << 26) // per_item)
    bounds = [(s, min(s + chunk, n)) for s in range(0, n, chunk)]
    parts = [corpus.index(slice(s, e)) for s, e in bounds]
    yys = [part.self_inners() for part in parts]
    rows = []
    for i in range(queries.leaves[0].shape[0]):
        q = queries.index(slice(i, i + 1))
        q = q.with_leaves(leaf.clone(memory_format=torch.contiguous_format)
                          for leaf in q.leaves)
        qq = q.self_inners()
        qb = q.index((slice(None), None))
        out = []
        for part, yy in zip(parts, yys):
            qy = contractions.pair_inners(qb, part.index((None,)))
            if metric == "euclidean":
                d2 = qq[:, None] + yy[None] - 2.0 * qy
                out.append(torch.sqrt(torch.clamp(d2, min=0.0)))
            else:
                nq = torch.sqrt(torch.clamp(qq, min=0.0))
                ny = torch.sqrt(torch.clamp(yy, min=0.0))
                out.append(qy / (nq[:, None] * ny[None]))
        rows.append(torch.cat(out, dim=1))
    if not rows:
        return torch.empty((0, n), device=corpus.device)
    return torch.cat(rows, dim=0)


def brute_force_batch(metric: str, queries, corpus, topk: int = 10):
    """Exact top-k over the whole corpus -> (ids (B, topk) int64 numpy,
    scores (B, topk) numpy); score ties resolve to the lower id. A dense
    corpus and queries may come as plain tensors."""
    _check_metric(metric)
    corpus = as_batch(corpus)
    queries = as_batch(queries, len(corpus.dims))
    scores = _score_matrix(metric, queries, corpus)
    order = torch.argsort(scores if metric == "euclidean" else -scores,
                          dim=1, stable=True)[:, :topk]
    return (order.cpu().numpy(),
            torch.gather(scores, 1, order).cpu().numpy())


def brute_force(metric: str, x, corpus, topk: int = 10):
    """Exact top-k of one query over the whole corpus -> (ids (topk,)
    int64, scores (topk,)) numpy: row 0 of ``brute_force_batch``."""
    ids, scores = brute_force_batch(metric, batch_of_one(x), corpus, topk)
    return ids[0], scores[0]


def recall_at_k(index, queries, topk: int = 10,
                probes: int = 1) -> dict[str, float]:
    """Mean recall@k of ``index.query_batch`` against brute force over the
    effective corpus."""
    queries = as_batch(queries, len(index.family.projection.dims))
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
