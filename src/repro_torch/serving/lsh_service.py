"""Batched LSH similarity-search service with streaming mutations
(reference: ``repro.serving.lsh_service``).

A corpus of CP or TT tensors, or a plain (n, d_1, ..., d_N) dense tensor, is
hashed once at build time (K3 for CP under a CP family, K4 for TT under TT,
the fp32 matrix products of ``ops.dense_hash`` for the naive kinds 'e2lsh'
/ 'srp' over any corpus and for CP or TT families over a dense one), and
query batches run the same hash (``raw``) then K1 (multi-probe expansion,
probe of every segment, dedup, exact re-rank in the corpus' format, dense
rows included, top-k) without leaving the card until the final (B, topk)
results. ``insert`` / ``delete`` / ``prepare_compact`` /
``apply_swap`` / ``compact`` mutate the store, with the reference's
counters in ``ServiceStats``.

``LSHService(..., shards=S)`` serves through ``ShardedLSHIndex``: S
per-shard sorted tables, ``insert`` routed to the least-loaded shards as
one delta slab, ``compact()`` shard-local, and ``prepare_rebalance`` /
``rebalance`` re-partitioning the live corpus when occupancy skews
(``ServiceStats.shard_occupancy`` / ``occupancy_skew`` / ``rebalances``
track it, from the store's per-slot bookkeeping). The index's ``build``
resolves a mesh where the reference does (an ``axis_rules`` context, else
the first S local devices): on a mesh a query runs one K1s launch a slot
and merges (``query_path`` "shard_map"), without one a single K1s launch
over every (shard, segment) pair ("vmap").

``query_mode`` / a request's ``mode`` "uniform" or "weighted" samples
``topk`` distinct members of each query's probed bucket union instead of
the exact top-k, seeded by the request's ``seed`` alone (a
``torch.Generator`` made from it per request: the same seed on the same
store replays the draw); ``ServiceStats`` counts the queries of each mode.

``build_service(..., device=False)`` / ``LSHService(..., device=False)``
serve through ``HostLSHIndex`` (the dict-of-buckets build kept as the
membership reference), as the reference's do: queries run through the same
K1 planner, mutations are rebuild-only and refused with the reference's
``TypeError``, and ``shards`` / ``bucket_cap`` are refused. The family and
the store stay on the card: a sampled family is made on "cuda", a
carried-over one (``family=``) keeps its own device. Otherwise ``device``
is the torch device the service runs on ("cuda" by default; "cpu" runs the
kernels' plain versions).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.index import (QUERY_MODES, DeviceLSHIndex,
                                    HostLSHIndex, ShardedLSHIndex,
                                    _SegmentedIndex)
from repro_torch.core.lsh import LSHFamily, make_family
from repro_torch.core.tensor_formats import as_batch
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ServiceStats:
    queries: int = 0
    batches: int = 0
    total_ms: float = 0.0
    total_candidates: int = 0
    # per-mode query counters (topk + uniform + weighted == queries)
    topk_queries: int = 0
    uniform_queries: int = 0
    weighted_queries: int = 0
    build_s: float = 0.0
    hash_s: float = 0.0        # part of build_s spent hashing (K3 / K4)
    sort_s: float = 0.0        # part of build_s spent sorting the tables
    # mutation counters
    inserted: int = 0          # items appended via insert()
    insert_batches: int = 0
    insert_ms: float = 0.0     # insert wall time, auto-compaction excluded
    deleted: int = 0           # items tombstoned via delete()
    delete_batches: int = 0
    compactions: int = 0       # explicit compact()/apply_swap publications
    compact_ms: float = 0.0    # explicit compact build wall time only
    auto_compactions: int = 0  # max_deltas-triggered folds inside insert()
    auto_compact_ms: float = 0.0
    rebalances: int = 0        # explicit cross-shard re-partitions
    rebalance_ms: float = 0.0
    rejected: int = 0          # requests refused by a tenant quota
                               # (set by the serving scheduler)
    shard_occupancy: tuple[int, ...] = ()  # live items per shard (sharded
                                           # index only; updated per mutation)
    # serving-plane counters (set by the serving scheduler)
    errors: int = 0            # failed ingest-lane mutations
    last_error: str = ""       # "<Type>: <message>" of the newest failure
    retries: int = 0           # ingest retries after transient IO failures
    timeouts: int = 0          # requests expired past the scheduler deadline
    unavailable: int = 0       # requests shed while degraded / recovering
    # durability counters (set by ``durability.DurableLSHService``)
    recoveries: int = 0        # successful snapshot+replay recoveries
    recovery_ms: float = 0.0   # restore + replay wall time
    wal_appends: int = 0       # committed WAL records
    wal_ms: float = 0.0        # fsync-inclusive WAL append wall time
    snapshots: int = 0         # atomic snapshots written
    snapshot_ms: float = 0.0

    @property
    def occupancy_skew(self) -> float:
        """max/mean live items per shard (1.0 = perfectly balanced)."""
        occ = self.shard_occupancy
        if not occ or not sum(occ):
            return 1.0
        return max(occ) * len(occ) / sum(occ)

    @property
    def mean_latency_ms(self):
        return self.total_ms / max(self.queries, 1)

    @property
    def mean_candidates(self):
        return self.total_candidates / max(self.queries, 1)

    @property
    def qps(self):
        return self.queries / max(self.total_ms / 1e3, 1e-9)

    @property
    def insert_items_per_s(self):
        return self.inserted / max(self.insert_ms / 1e3, 1e-9)

    def reset(self):
        """Zero the query counters (e.g. after warm-up); keeps the build
        times and the mutation counters."""
        self.queries = self.batches = 0
        self.topk_queries = self.uniform_queries = self.weighted_queries = 0
        self.total_ms = 0.0
        self.total_candidates = 0

    def reset_mutations(self):
        """Zero the mutation counters (every build does, so the stats
        describe the live index only)."""
        self.inserted = self.insert_batches = 0
        self.deleted = self.delete_batches = 0
        self.compactions = self.auto_compactions = self.rebalances = 0
        self.insert_ms = self.compact_ms = self.auto_compact_ms = 0.0
        self.rebalance_ms = 0.0
        self.rejected = 0
        self.shard_occupancy = ()
        self.errors = self.retries = self.timeouts = self.unavailable = 0
        self.last_error = ""
        self.recoveries = self.wal_appends = self.snapshots = 0
        self.recovery_ms = self.wal_ms = self.snapshot_ms = 0.0


class LSHService:
    """build() once, then serve query batches and streaming mutations."""

    def __init__(self, family: LSHFamily, metric: str = "euclidean",
                 bucket_cap: int | None = None, shards: int | None = None,
                 max_deltas: int = 8, probes: int = 1,
                 query_mode: str = "topk", device: bool = True):
        if int(probes) < 1:
            raise ValueError(f"probes must be >= 1, got {probes}")
        if query_mode not in QUERY_MODES:
            raise ValueError(f"unknown query_mode {query_mode!r}; expected "
                             f"one of {QUERY_MODES}")
        self.probes = int(probes)
        self.query_mode = query_mode
        if shards is not None:
            if not device:
                raise ValueError(
                    "shards requires the device index (pass device=True); "
                    "the host-dict path has no sharded layout")
            self.index = ShardedLSHIndex(family, metric=metric,
                                         shards=shards, bucket_cap=bucket_cap,
                                         max_deltas=max_deltas)
        elif device:
            self.index = DeviceLSHIndex(family, metric=metric,
                                        bucket_cap=bucket_cap,
                                        max_deltas=max_deltas)
        else:
            if bucket_cap is not None:
                raise ValueError(
                    "bucket_cap applies to the device index only; the host "
                    "index always probes full buckets (pass device=True)")
            self.index = HostLSHIndex(family, metric=metric)
        self.stats = ServiceStats()
        self.health = "serving"  # namespace health; the scheduler marks a
                                 # namespace "degraded" after a failure

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def devices(self) -> tuple:
        """Every device the service's index lies on, its own first (a mesh
        index's slots after it)."""
        return getattr(self.index, "devices", (self.device,))

    def build(self, corpus, batch_size: int = 65536) -> "LSHService":
        t0 = time.perf_counter()
        self.index.build(corpus, batch_size=batch_size)
        self.stats.build_s = time.perf_counter() - t0
        self.stats.hash_s = self.index.hash_s
        self.stats.sort_s = self.index.sort_s
        self.stats.reset_mutations()
        self._track_shards()
        return self

    # -- queries ------------------------------------------------------------

    def query_arrays(self, queries, topk: int = 10, *,
                     probes: int | None = None, mode: str | None = None,
                     seed: int | None = None, stat_rows: int | None = None):
        """Batched raw results: (ids (B, topk), scores (B, topk), n_cand (B,))
        numpy arrays; ids -1-filled where a row has fewer than topk
        candidates. Requests are validated with the reference's contract.
        The sampling modes ("uniform" / "weighted") draw ``topk`` distinct
        members of each query's probed union and need an explicit ``seed``
        (the draw's generator is made from it and nothing else, so a seed
        replays the draw on the same store); "topk" refuses one.
        ``stat_rows`` caps the rows the query counters count: a caller that
        pads a batch passes its real row count, so pad rows never count.
        The batch runs on the current stream; the one copy of the results
        to the host waits for that stream only."""
        probes = self.probes if probes is None else int(probes)
        if probes < 1:
            raise ValueError(f"probes must be >= 1, got {probes}")
        if int(topk) < 1:
            raise ValueError(f"topk must be >= 1, got {topk}")
        mode = self.query_mode if mode is None else mode
        if mode not in QUERY_MODES:
            raise ValueError(f"unknown query mode {mode!r}; expected one "
                             f"of {QUERY_MODES}")
        rng = None
        if mode in ("uniform", "weighted"):
            if seed is None:
                raise ValueError(
                    f"mode={mode!r} needs an explicit per-request seed "
                    "(sampling draws are seeded, never implicit)")
            rng = torch.Generator().manual_seed(int(seed))
        elif seed is not None:
            raise ValueError("seed applies to the sampling modes only; "
                             "mode='topk' is deterministic")
        queries = as_batch(queries, len(self.index.family.projection.dims))
        n = queries.leaves[0].shape[0]
        if stat_rows is not None:
            n = min(n, int(stat_rows))
        t0 = time.perf_counter()
        ids, scores, n_cand = self.index.query_batch(queries, topk=int(topk),
                                                     probes=probes, mode=mode,
                                                     rng=rng)
        # one device-to-host copy of the three results, split on the host
        host = torch.cat([ids, scores.view(torch.int32), n_cand[:, None]],
                         dim=1).cpu().numpy()
        k = ids.shape[1]
        ids, scores, n_cand = (np.ascontiguousarray(host[:, :k]),
                               host[:, k:2 * k].view(np.float32).copy(),
                               host[:, 2 * k].copy())
        dt = (time.perf_counter() - t0) * 1e3
        self.stats.queries += n
        setattr(self.stats, f"{mode}_queries",
                getattr(self.stats, f"{mode}_queries") + n)
        self.stats.batches += 1
        self.stats.total_ms += dt
        self.stats.total_candidates += int(n_cand.sum())
        return ids, scores, n_cand

    def query_batch(self, queries, topk: int = 10, *,
                    probes: int | None = None, mode: str | None = None,
                    seed: int | None = None) -> list[dict[str, Any]]:
        """Per-query result dicts (ids/scores trimmed of -1 fill)."""
        ids, scores, n_cand = self.query_arrays(queries, topk=topk,
                                                probes=probes, mode=mode,
                                                seed=seed)
        out = []
        for row_ids, row_scores, nc in zip(ids, scores, n_cand):
            mask = row_ids >= 0
            out.append({"ids": row_ids[mask], "scores": row_scores[mask],
                        "candidates": int(nc)})
        return out

    # -- mutations ----------------------------------------------------------

    def _mutable_index(self) -> _SegmentedIndex:
        if not isinstance(self.index, _SegmentedIndex):
            raise TypeError(
                "the host index is rebuild-only; streaming mutations need "
                "the device or sharded index (device=True)")
        return self.index

    def _track_shards(self) -> None:
        if isinstance(self.index, ShardedLSHIndex):
            self.stats.shard_occupancy = tuple(
                int(c) for c in self.index.occupancy())

    def _sync_mutation_stats(self) -> None:
        """Mirror the index's counters, splitting max_deltas-triggered
        folds from explicit publications."""
        index = self.index
        self.stats.auto_compactions = index.auto_compactions
        self.stats.auto_compact_ms = index.auto_compact_s * 1e3
        self.stats.compactions = index.compactions - index.auto_compactions
        self.stats.rebalances = getattr(index, "rebalances", 0)

    def insert(self, batch, batch_size: int = 2048) -> "LSHService":
        """Append a batch of items (one delta segment, a routed slab on the
        sharded index, served immediately). A max_deltas auto-compaction
        triggered here is timed into ``auto_compact_ms``, never
        ``insert_ms``."""
        index = self._mutable_index()
        batch = as_batch(batch, len(index.family.projection.dims))
        n = batch.leaves[0].shape[0]
        auto_s0 = index.auto_compact_s
        t0 = time.perf_counter()
        index.insert(batch.to(self.device), batch_size=batch_size)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.stats.insert_ms += dt_ms - (index.auto_compact_s - auto_s0) * 1e3
        self.stats.inserted += n
        self.stats.insert_batches += 1
        self._sync_mutation_stats()
        self._track_shards()
        return self

    def delete(self, ids) -> int:
        """Tombstone items by their current effective ids; returns count."""
        n = self._mutable_index().delete(ids)
        self.stats.deleted += n
        self.stats.delete_batches += 1
        self._track_shards()
        return n

    def prepare_compact(self):
        """Build the compacted replacement store off the query path and
        return the pending swap (None when there is nothing to fold); the
        build wall time lands in ``compact_ms``."""
        index = self._mutable_index()
        t0 = time.perf_counter()
        pending = index.prepare_compact()
        self.stats.compact_ms += (time.perf_counter() - t0) * 1e3
        return pending

    def apply_swap(self, pending) -> "LSHService":
        """Publish a prepared store: one attribute write, no device work.
        Raises RuntimeError if the index mutated since the prepare."""
        self._mutable_index().apply_swap(pending)
        self._sync_mutation_stats()
        self._track_shards()
        return self

    def compact(self) -> "LSHService":
        """Fold deltas + tombstones back into the base (prepare + flip;
        shard-local on the sharded index: shards keep their item mix)."""
        return self.apply_swap(self.prepare_compact())

    def prepare_rebalance(self):
        """Build the re-partitioned replacement store off the query path
        (sharded index only); publish it with ``apply_swap``. The build
        wall time lands in ``rebalance_ms``."""
        index = self._mutable_index()
        if not isinstance(index, ShardedLSHIndex):
            raise TypeError("rebalance applies to the sharded index only "
                            "(pass shards=S)")
        t0 = time.perf_counter()
        pending = index.prepare_rebalance()
        self.stats.rebalance_ms += (time.perf_counter() - t0) * 1e3
        return pending

    def rebalance(self) -> "LSHService":
        """Re-partition the live corpus into contiguous, evenly sized
        shards (the explicit cross-shard move; sharded index only)."""
        return self.apply_swap(self.prepare_rebalance())


def build_service(key: torch.Generator, kind: str, dims: Sequence[int],
                  corpus, *, metric: str | None = None,
                  num_codes: int = 8, num_tables: int = 8, rank: int = 4,
                  bucket_width: float = 4.0, device="cuda",
                  bucket_cap: int | None = None, shards: int | None = None,
                  max_deltas: int = 8, probes: int = 1,
                  query_mode: str = "topk",
                  family: LSHFamily | None = None) -> LSHService:
    """Sample a family of any of the six kinds (``kind``) from ``key`` (a
    ``torch.Generator``), build the index over ``corpus`` on ``device`` and
    return the service. ``corpus`` is a batched ``CPTensor`` or
    ``TTTensor`` of the kind's format, or a plain (n, d_1, ..., d_N) dense
    tensor under any kind; the naive kinds 'e2lsh' / 'srp' also take CP and
    TT corpora (densified to hash, re-ranked in their format).

    ``family`` serves a family made elsewhere instead of sampling one (e.g.
    parameters carried over from the reference with
    ``repro_torch.convert.family_from_numpy``); ``key`` is then unused and
    ``kind``, ``num_codes`` and ``num_tables`` must match it. The corpus is
    moved to ``device``. ``shards`` = S serves the sharded index (S shards
    on ``device``). The reference's ``hash_backend`` / ``probe_backend``
    knobs do not exist here: the tensors' device picks kernel or plain path.
    ``device=False`` serves the host-dict index (``HostLSHIndex``) on the
    family's device: "cuda" for a sampled family, its own for a carried-over
    one.
    """
    host = device is False
    if host:
        if shards is not None:
            raise ValueError(
                "shards requires the device index (pass device=True); the "
                "host-dict path has no sharded layout")
        device = family.device if family is not None else "cuda"
    dev = resolve_device(device)
    metric = metric or ("cosine" if kind.endswith("srp") else "euclidean")
    if family is None:
        family = make_family(key, kind, dims, num_codes=num_codes,
                             num_tables=num_tables, rank=rank,
                             bucket_width=bucket_width, device=dev)
    elif (family.kind, family.num_codes, family.num_tables) != (
            kind, num_codes, num_tables):
        raise ValueError(
            f"family is ({family.kind}, K={family.num_codes}, "
            f"L={family.num_tables}); build_service was asked for ({kind}, "
            f"K={num_codes}, L={num_tables})")
    elif family.device != dev:
        raise ValueError(f"family on {family.device}, device={dev}")
    return LSHService(family, metric=metric, bucket_cap=bucket_cap,
                      shards=shards, max_deltas=max_deltas, probes=probes,
                      query_mode=query_mode, device=not host).build(
                          as_batch(corpus, len(dims)).to(dev))
