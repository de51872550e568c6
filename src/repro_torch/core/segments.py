"""Sorted segments, the mutable segment store and the query planners
(reference: ``repro.core.segments``), on one device or over a mesh.

A segment is, per hash table, the bucket keys of its items sorted ascending,
the matching permutation of local item ids, and the corpus the ids point
into:

  ``TableSegment``    keys (m, L) in corpus order, sorted_keys (L, m), perm
                      (L, m) int32, the corpus (a batched CP or TT tensor),
                      the cap, and ``stacked``: the corpus in the kernels'
                      layout ((m, N, d, R) CP, (m, N, R, d, R) TT), whose
                      views the corpus factors or cores are.
  ``ShardedSegment``  the same arrays with a leading shard dim S: keys
                      (S, n_s, L), sorted_keys / perm (S, L, n_s), the
                      corpus and ``stacked`` (S, n_s, ...) zero-padded, and
                      the real item count of each shard. Pad slots carry
                      ``_PAD_KEY`` and the perm sentinel n_s. The sharded
                      base and the routed delta slabs share this layout.

Bucket keys are uint32 values held in int64. ``SegmentStore`` is one base
segment plus bounded delta segments (streaming inserts) and a host
tombstone mask (streaming deletes; shard pads are born dead). Queries
return *effective* ids, the rank of an item among the live items in
sequence (arrival) order, via a host ``slot_pos`` map per segment. After
every mutation the store derives, per segment, the device lookups a query
reads (``live`` (m+1,) bool with entry m False, ``eff`` (m,) int32 and, for
an explicit ``bucket_cap``, the live-window lookups ``live_rank`` (L, m+1)
/ ``live_pos`` (L, m); sharded: (S, n_s+1), (S, n_s), (S, L, n_s+1),
(S, L, n_s)) and publishes them in one immutable ``StoreView``: once per
mutation, never once per query batch. The host bookkeeping stays numpy, as
in the reference.

On the card a view is published on the stream that built it (the serving
scheduler's ingest lane) and read on another (its query lane): the view
carries an event recorded after its last upload, and ``StoreView.acquire``
makes the reading stream wait on it and marks the view's arrays as in use
on that stream (``Tensor.record_stream``), so the memory of a replaced
store is handed out again only after the queries that read it have run.
The chunked, throttled shadow build (``gather_rows_chunked``,
``_sort_tables_throttled``, ``_slab_gather_keys`` / ``_sort_shard_table``,
``SegmentStore.effective_arrays_chunked``) issues a fold as bounded steps,
synchronizing its own stream after each, so the query lane's kernels
interleave with it; its arrays are bit-equal to the one-pass fold's.

A sharded segment is held on the index's one device, or, on a mesh
(``distributed.index_sharding``), as S per-slot *blocks*: one-shard
``ShardedSegment``s, each on its slot's device, and no copy of the whole
on the home device (the device the index hashes on). The routed slabs
(``build_sharded_delta(devices=...)``), the per-slot lookups, the store's
gathers (``effective_arrays[_chunked]``, ``effective_corpus``) and the
store's view (``StoreView.slots``: one view a slot, each with its own K1
table) then work a slot at a time on the slot's device; the values equal
the one-device layout's slices bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import contractions
from repro_torch.core.tensor_formats import CPTensor, TTTensor
from repro_torch.kernels.ops import unstack_like

_PAD_KEY = 0xFFFFFFFF      # bucket key of shard-padding slots


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

    def shard(self, s: int) -> "SegmentArrays":
        """Shard ``s`` of a sharded segment's arrays (each with a leading
        shard dim): contiguous views, no copy."""
        win = None if self.win is None else (self.win[0][s], self.win[1][s])
        return SegmentArrays(self.corpus.index(s), self.sorted_keys[s],
                             self.perm[s], self.live[s], self.eff[s], win,
                             self.stacked[s])


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


def k1_probe_keys(family, mults, queries, probes: int = 1) -> torch.Tensor:
    """The (L, T, B) ranked bucket keys a query batch probes on the query
    path: the batch stacked and projected through the hash path
    (``family.raw_stacked``: K3 / K4's ``raw`` epilogue on the card), then
    discretized, combined and expanded as K1 does in-kernel
    (``fused_query.probe_keys_from_values``). ``query_keys`` takes its
    multi-probe residuals from the plain projection path instead, which
    may differ from these values by rounding at a bucket edge."""
    from repro_torch.kernels.fused_query import probe_keys_from_values
    from repro_torch.kernels.ops import mults_tensor

    t = int(probes)
    if t < 1:
        raise ValueError(f"probes must be >= 1, got {probes}")
    family.check_inputs(queries)
    x, stacked = queries.stack()
    values = family.raw_stacked(stacked, x.scale)
    return probe_keys_from_values(
        values, family.offsets, mults_tensor(mults, values.device),
        e2=family.kind.endswith("e2lsh"), w=family.bucket_width,
        num_tables=family.num_tables, num_codes=family.num_codes, probes=t)


def _run_lengths(sorted_keys: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Per position, the length of the run of equal values that ends there
    along the last axis, counting only ``valid`` positions (runs break at
    invalid slots, which read 0)."""
    n = sorted_keys.shape[-1]
    idx = torch.arange(n, device=sorted_keys.device)
    new_run = torch.cat([torch.ones_like(valid[..., :1]),
                         (sorted_keys[..., 1:] != sorted_keys[..., :-1])
                         | ~valid[..., :-1]], dim=-1)
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=-1).values
    return torch.where(valid, idx - run_start + 1, 0)


def _max_run_length_masked(sorted_keys: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Longest run of equal values along the last axis, counting only
    ``valid`` positions. Pad slots sort to the tail of their key run
    (stable sort, pads carry the largest local ids), so masking them gives
    the largest *stored* bucket."""
    if sorted_keys.shape[-1] == 0:
        return torch.tensor(0)
    return _run_lengths(sorted_keys, valid).max()


def _max_run_length(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Longest run of equal values along the last axis of sorted keys."""
    return _max_run_length_masked(
        sorted_keys, torch.ones_like(sorted_keys, dtype=torch.bool))


def _shard_max_runs(sorted_keys: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """(S, L, n_s) sorted keys and slot validity -> (S,) each shard's
    longest stored run."""
    return _run_lengths(sorted_keys, valid).flatten(1).amax(1)


def _sort_tables(keys_t: torch.Tensor):
    """(..., L, m) keys -> (perm int32, sorted_keys, max_run): a stable sort
    along the last axis (the keys are non-negative, so the signed sort is
    the unsigned order)."""
    sorted_keys, perm = torch.sort(keys_t, dim=-1, stable=True)
    return perm.to(torch.int32), sorted_keys, _max_run_length(sorted_keys)


def _warn_coarse(layout: str, cap: int, num_tables: int, n: int,
                 shards: int = 1) -> None:
    """The exact default cap would gather more candidates than the store
    (for a sharded base, one shard: ``n`` is then the per-shard item count)
    holds: the family is too coarse for this data."""
    if not n or cap * num_tables <= n:
        return
    fix = ("The family is too coarse for this data; raise num_codes / "
           "shrink bucket_width, or pass an explicit bucket_cap to bound "
           "{} work at some recall cost.")
    if shards > 1:
        warnings.warn(
            f"{layout}: largest per-shard bucket has {cap} of {n} items, so "
            f"the exact default cap gathers up to S*L*cap="
            f"{shards * num_tables * cap} candidates per query (more than a "
            "shard holds). " + fix.format("per-shard"))
    else:
        warnings.warn(
            f"{layout}: largest bucket has {cap} of {n} items, so the exact "
            f"default cap gathers up to L*cap={cap * num_tables} candidates "
            "per query (more than the corpus). " + fix.format("per-query"))


@dataclasses.dataclass(frozen=True)
class TableSegment:
    """One immutable sorted run (see the module docstring)."""

    keys: torch.Tensor          # (m, L) corpus order
    sorted_keys: torch.Tensor   # (L, m) ascending per table
    perm: torch.Tensor          # (L, m) int32 local ids in sorted-key order
    corpus: CPTensor | TTTensor  # batched, leaves (m, ...)
    cap: int                    # probe width: the largest bucket at build
    stacked: torch.Tensor       # the kernel layout of the corpus

    blocks = ()                 # never on a mesh (``ShardedSegment``'s are)
    devices = ()

    @property
    def slots(self) -> int:
        return self.keys.shape[0]

    @property
    def items(self) -> int:     # every slot holds a real item
        return self.keys.shape[0]


def build_segment(keys: torch.Tensor, corpus, *,
                  bucket_cap: int | None = None,
                  warn_layout: str | None = None,
                  sort_throttled: bool = False,
                  stacked: torch.Tensor | None = None) -> TableSegment:
    """(m, L) corpus-order keys + CP or TT corpus -> sorted TableSegment.
    The cap is the largest bucket (exact candidate sets, with the
    coarse-family warning for base builds, ``warn_layout`` set) or
    min(``bucket_cap``, m). The corpus is stacked after the sort, so the
    sort's temporaries are freed before the stacked copy is made; a
    ``stacked`` corpus already in the kernels' layout (``corpus`` its
    views) is kept as it is. ``sort_throttled`` sorts table by table
    (``_sort_tables_throttled``, the same values) so that a shadow build's
    sort stays off a concurrent query's critical path."""
    m = keys.shape[0]
    sorter = _sort_tables_throttled if sort_throttled else _sort_tables
    perm, sorted_keys, max_run = sorter(keys.T.contiguous())
    if bucket_cap is None:
        cap = int(max_run) if m else 0
        if warn_layout is not None:
            _warn_coarse(warn_layout, cap, keys.shape[1], m)
    else:
        cap = min(int(bucket_cap), m)
    if stacked is None:
        corpus, stacked = corpus.stack()
    return TableSegment(keys=keys, sorted_keys=sorted_keys, perm=perm,
                        corpus=corpus, cap=cap, stacked=stacked)


@dataclasses.dataclass(frozen=True)
class ShardedSegment:
    """Sharded arrays with a leading shard dim: the sharded *base* and the
    routed delta *slabs* share this layout.

    Shard ``s`` holds ``counts[s]`` real items in slots [0, counts[s]) of
    its slab; the other slots are padding (key ``_PAD_KEY``, perm entry the
    ``shard_size`` sentinel, a zero corpus row), so a probe that lands on
    one, even through a ``_PAD_KEY`` collision, is masked as a miss by the
    liveness lookup. A fresh contiguous build fills every shard but the
    last; slabs and shard-locally compacted bases carry any counts.

    On a mesh the arrays are None and ``blocks`` holds the S shards as
    one-shard segments (arrays (1, ...)), block ``s`` on its slot's device
    (``place_blocks``); ``home`` is the device the index hashes on, where
    the store's gathers land.
    """

    keys: torch.Tensor | None   # (S, n_s, L) corpus order, pads _PAD_KEY
    sorted_keys: torch.Tensor | None  # (S, L, n_s) ascending per (shard,
                                      # table)
    perm: torch.Tensor | None   # (S, L, n_s) int32, pad slots -> n_s
    corpus: CPTensor | TTTensor | None  # leaves (S, n_s, ...), views of
                                        # stacked
    cap: int                    # probe width: the largest per-shard bucket
    counts: tuple[int, ...]     # real items per shard
    stacked: torch.Tensor | None  # (S, n_s, N, d, R) / (S, n_s, N, R, d, R)
    blocks: tuple = ()          # mesh: per-slot one-shard segments
    home: torch.device | None = None  # mesh: the index's device

    @property
    def items(self) -> int:     # real (unpadded) item count
        return sum(self.counts)

    @property
    def shards(self) -> int:
        return len(self.blocks) if self.blocks else self.keys.shape[0]

    @property
    def shard_size(self) -> int:
        return (self.blocks[0] if self.blocks else self).keys.shape[1]

    @property
    def slots(self) -> int:
        return self.shards * self.shard_size

    @property
    def devices(self) -> tuple:
        """The slots' devices, in shard order (empty off a mesh)."""
        return tuple(b.keys.device for b in self.blocks)

    @property
    def flat_corpus(self):
        """The corpus with its (S, n_s) slots flattened, in slot order."""
        c = self.corpus
        return c.with_leaves(a.flatten(0, 1) for a in c.leaves)


def mesh_segment(blocks, cap: int, home) -> ShardedSegment:
    """A sharded segment held as per-slot one-shard ``blocks`` (each with
    its own device), every block probed with the segment's ``cap``."""
    blocks = tuple(dataclasses.replace(b, cap=int(cap)) for b in blocks)
    return ShardedSegment(keys=None, sorted_keys=None, perm=None,
                          corpus=None, cap=int(cap),
                          counts=tuple(b.counts[0] for b in blocks),
                          stacked=None, blocks=blocks,
                          home=torch.device(home))


def place_blocks(seg: ShardedSegment, devices) -> ShardedSegment:
    """A one-device sharded segment -> the same segment as per-slot blocks,
    shard ``s`` copied to ``devices[s]`` (its own memory, even where the
    device is the segment's: no block is a view of the whole), with the
    segment's device as the mesh's home."""
    if seg.blocks:
        raise ValueError("the segment is already placed on a mesh")
    if len(devices) != seg.shards:
        raise ValueError(f"{seg.shards} shards over {len(devices)} slots")
    blocks = []
    for s, dev in enumerate(devices):
        stacked = seg.stacked[s:s + 1].to(dev, copy=True)
        blocks.append(ShardedSegment(
            keys=seg.keys[s:s + 1].to(dev, copy=True),
            sorted_keys=seg.sorted_keys[s:s + 1].to(dev, copy=True),
            perm=seg.perm[s:s + 1].to(dev, copy=True),
            corpus=unstack_like(seg.corpus, stacked), cap=seg.cap,
            counts=(seg.counts[s],), stacked=stacked))
    return mesh_segment(blocks, seg.cap, seg.keys.device)


def gather_blocks(seg: ShardedSegment) -> ShardedSegment:
    """A mesh segment's blocks concatenated in shard order on its home
    device: the one-device segment it was placed from (a copy made on
    demand, never kept by the store)."""
    if not seg.blocks:
        return seg
    home = seg.home
    cat = lambda name: torch.cat([getattr(b, name).to(home)
                                  for b in seg.blocks])
    stacked = cat("stacked")
    return ShardedSegment(keys=cat("keys"), sorted_keys=cat("sorted_keys"),
                          perm=cat("perm"),
                          corpus=unstack_like(seg.blocks[0].corpus, stacked),
                          cap=seg.cap, counts=seg.counts, stacked=stacked)


def build_sharded_segment(keys: torch.Tensor, corpus, shards: int, *,
                          bucket_cap: int | None = None,
                          warn_layout: str | None = None) -> ShardedSegment:
    """(n, L) corpus-order keys + CP or TT corpus -> S-sharded segment.

    The corpus is split into S contiguous slices of n_s = ceil(n / S); the
    last is padded (pad keys ``_PAD_KEY``, pad perm entries the n_s
    sentinel, zero rows). The exact cap is the longest run of one sort over
    every (shard, table), pad keys included, as in the reference."""
    n, num_tables = keys.shape
    n_s = max(-(-n // shards), 1)
    pad = shards * n_s - n
    keys_sh = torch.cat([keys, keys.new_full((pad, num_tables), _PAD_KEY)])
    keys_sh = keys_sh.reshape(shards, n_s, num_tables)
    perm, sorted_keys, max_run = _sort_tables(
        keys_sh.transpose(1, 2).contiguous())
    # pad slots get the n_s sentinel: the liveness lookup masks them
    offsets = torch.arange(shards, device=keys.device)[:, None, None] * n_s
    perm = torch.where(offsets + perm >= n, n_s, perm)
    _, stacked = corpus.stack()
    stacked = torch.cat([stacked, stacked.new_zeros((pad,)
                                                    + stacked.shape[1:])])
    stacked = stacked.unflatten(0, (shards, n_s))
    if bucket_cap is None:
        cap = int(max_run) if n else 0
        if warn_layout is not None:
            _warn_coarse(warn_layout, cap, num_tables, n_s, shards)
    else:
        cap = min(int(bucket_cap), n_s)
    counts = tuple(int(np.clip(n - s * n_s, 0, n_s)) for s in range(shards))
    return ShardedSegment(keys=keys_sh, sorted_keys=sorted_keys, perm=perm,
                          corpus=unstack_like(corpus, stacked), cap=cap,
                          counts=counts, stacked=stacked)


# ---------------------------------------------------------------------------
# Routed delta slabs + the shard-local fold
# ---------------------------------------------------------------------------


def route_balanced(batch_n: int, loads) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic balance policy: fill the least-loaded shard first.

    -> (alloc (S,), offsets (S,)) int64 in shard-id order: shard ``s`` takes
    the contiguous batch slab [offsets[s], offsets[s] + alloc[s]).
    Water-fill over ascending (load, shard id): the lowest shards are
    raised toward a common level, leftovers go one item each to the
    least-loaded shards, so steady ingest keeps shard occupancy within one
    item of even without moving stored rows."""
    loads = np.asarray(loads, np.int64)
    s = loads.size
    order = np.lexsort((np.arange(s), loads))
    lv = loads[order]
    alloc_sorted = np.zeros(s, np.int64)
    b = int(batch_n)
    if b > 0:
        for k in range(1, s + 1):
            room = int((lv[k] - lv[:k]).sum()) if k < s else b
            if room >= b:
                level, extra = divmod(int(lv[:k].sum()) + b, k)
                tgt = np.full(k, level, np.int64)
                tgt[:extra] += 1
                alloc_sorted[:k] = tgt - lv[:k]
                break
    alloc = np.zeros(s, np.int64)
    alloc[order] = alloc_sorted
    offsets = np.zeros(s, np.int64)
    offsets[order] = np.concatenate(([0], np.cumsum(alloc_sorted)[:-1]))
    return alloc, offsets


def _sort_slabs(keys_sh: torch.Tensor, counts: torch.Tensor,
                shard_size: int):
    """(S, n_s, L) slab keys with ``counts`` (S,) real rows per shard ->
    (sorted_keys, perm with the pad sentinel, (S,) longest stored runs)."""
    perm, sorted_keys, _ = _sort_tables(keys_sh.transpose(1, 2).contiguous())
    pad = perm >= counts[:, None, None]
    perm = torch.where(pad, shard_size, perm)
    return sorted_keys, perm, _shard_max_runs(sorted_keys, ~pad)


def build_sharded_delta(keys, corpus, alloc, offsets, *, seq0: int,
                        bucket_cap: int | None = None, devices=None
                        ) -> tuple[ShardedSegment, np.ndarray]:
    """(B, L) batch keys + batch corpus + a ``route_balanced`` plan ->
    (slab ShardedSegment, positions): the batch scattered into per-shard
    slabs (the reference's ``_slab_scatter_sort``), each sorted locally.

    ``positions`` is the (S * slab,) int64 slot -> sequence-position map
    (``seq0`` + batch row, -1 for pad slots) that
    ``SegmentStore.append_delta`` takes. The slab width is the largest
    per-shard allocation rounded up to 8, or to 64 from 256 slots on, as in
    the reference (whose program shapes are static: quantized widths keep
    steady ingest on one compiled program). With ``devices`` (a mesh's slot
    devices) the slab is built as per-slot blocks: each shard's rows are
    gathered on the batch's device, copied to its slot's device and sorted
    there."""
    b, _ = keys.shape
    s = alloc.size
    raw = max(int(alloc.max()), 1)
    q = 64 if raw >= 256 else 8
    slab = -(-raw // q) * q
    idx = np.full((s, slab), b, np.int64)
    pos = np.full((s, slab), -1, np.int64)
    for sh in range(s):
        c, o = int(alloc[sh]), int(offsets[sh])
        idx[sh, :c] = o + np.arange(c)
        pos[sh, :c] = seq0 + o + np.arange(c)
    # scatter: slot (shard, j) takes batch row idx[shard, j], row b a pad
    idx = torch.from_numpy(idx.reshape(-1)).to(keys.device)
    keys_sh = torch.cat([keys, keys.new_full((1, keys.shape[1]), _PAD_KEY)])
    _, stacked = corpus.stack()
    stacked = torch.cat([stacked,
                         stacked.new_zeros((1,) + stacked.shape[1:])])
    if devices is not None:
        return _mesh_delta(keys_sh, stacked, corpus, idx.unflatten(0, (s,
                                                                       slab)),
                           alloc, devices, bucket_cap), pos.reshape(-1)
    keys_sh = keys_sh[idx].unflatten(0, (s, slab))
    stacked_sh = stacked[idx].unflatten(0, (s, slab))
    sorted_keys, perm, max_runs = _sort_slabs(
        keys_sh, torch.from_numpy(alloc).to(keys.device), slab)
    cap = (min(int(bucket_cap), slab) if bucket_cap is not None
           else max(int(max_runs.max()), 1))
    seg = ShardedSegment(keys=keys_sh, sorted_keys=sorted_keys, perm=perm,
                         corpus=unstack_like(corpus, stacked_sh), cap=cap,
                         counts=tuple(int(a) for a in alloc),
                         stacked=stacked_sh)
    return seg, pos.reshape(-1)


def _mesh_delta(keys_sh, stacked, corpus, idx, alloc, devices,
                bucket_cap) -> ShardedSegment:
    """``build_sharded_delta``'s slab as per-slot blocks: slot ``s`` takes
    rows ``idx[s]`` of the padded batch keys / stacked corpus, copied to
    ``devices[s]`` and sorted there (``_sort_slabs`` over one shard: the
    one-device slab's slice, bit for bit)."""
    slab = idx.shape[1]
    blocks, runs = [], []
    for sh, dev in enumerate(devices):
        rows = idx[sh]
        k = keys_sh[rows].to(dev)[None]
        st = stacked[rows].to(dev)[None]
        sorted_keys, perm, max_runs = _sort_slabs(
            k, torch.tensor([int(alloc[sh])], device=dev), slab)
        runs.append(int(max_runs.max()))
        blocks.append(ShardedSegment(
            keys=k, sorted_keys=sorted_keys, perm=perm,
            corpus=unstack_like(corpus, st), cap=0,
            counts=(int(alloc[sh]),), stacked=st))
    cap = (min(int(bucket_cap), slab) if bucket_cap is not None
           else max(max(runs), 1))
    return mesh_segment(blocks, cap, keys_sh.device)


def _slab_gather_keys(keys_cat: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """The keys half of ``_slab_gather_sort``'s gather: (S, W, L) keys of
    the concatenated slot axis and (S, shard_size) ``idx`` (W marks a pad)
    -> (S, shard_size, L) keys, ``_PAD_KEY`` on pads. Keys are a few bytes
    an item, so the chunked fold takes them in one step."""
    s, w, num_tables = keys_cat.shape
    valid = idx < w
    keys_n = torch.gather(
        keys_cat, 1, torch.where(valid, idx, 0)[:, :, None]
        .expand(-1, -1, num_tables))
    return torch.where(valid[:, :, None], keys_n, _PAD_KEY)


def _sort_shard_table(keys_l: torch.Tensor, counts: torch.Tensor, *,
                      shard_size: int):
    """Sort ONE table's (S, shard_size) fold keys: the stable sort, the
    pad sentinel and the masked longest run that ``_sort_slabs`` applies
    to every table at once, so each output is a bit-equal slice of the
    one-pass fold's -> (perm (S, n_s) int32, sorted_keys, (S,) longest
    stored runs). The chunked fold issues L of these, synchronizing its
    stream between them."""
    sorted_keys, perm = torch.sort(keys_l, dim=-1, stable=True)
    perm = perm.to(torch.int32)
    pad = perm >= counts[:, None]
    perm = torch.where(pad, shard_size, perm)
    return perm, sorted_keys, _run_lengths(sorted_keys, ~pad).amax(-1)


def _slab_gather_sort(keys, stacked, idx, counts, *, shard_size):
    """The shard-local compaction fold: each shard gathers its survivors
    from its base slice and delta slabs and sorts them anew.

    ``keys`` / ``stacked`` are the segments' (S, w_g, L) keys and
    (S, w_g, ...) stacked corpora in slot-offset order; ``idx``
    (S, shard_size) indexes each shard's concatenated slot axis
    (W = sum w_g marks a pad), ``counts`` (S,) the survivors per shard.
    -> (keys (S, shard_size, L), sorted_keys, perm, stacked, (S,) longest
    stored runs). One pass: the keys are gathered from their concatenation
    (a few bytes an item), the corpus rows straight from each segment. The
    values equal the reference's fold and its chunked form
    (``_slab_gather_keys``, ``_sort_shard_table``,
    ``gather_rows_chunked``)."""
    keys_n = _slab_gather_keys(torch.cat(list(keys), dim=1), idx)
    s = keys_n.shape[0]
    out = stacked[0].new_zeros((s * shard_size,) + stacked[0].shape[2:])
    off = 0
    for g in stacked:
        wg = g.shape[1]
        sh, col = torch.nonzero((idx >= off) & (idx < off + wg),
                                as_tuple=True)
        out[sh * shard_size + col] = g.flatten(0, 1)[sh * wg + idx[sh, col]
                                                     - off]
        off += wg
    sorted_keys, perm, max_runs = _sort_slabs(keys_n, counts, shard_size)
    return (keys_n, sorted_keys, perm, out.unflatten(0, (s, shard_size)),
            max_runs)


# ---------------------------------------------------------------------------
# The chunked, throttled shadow build
# ---------------------------------------------------------------------------


_COOPERATIVE = threading.local()   # this thread's (yield_s, busy)


@contextlib.contextmanager
def cooperative_build(yield_s: float = 0.008, busy=None):
    """Make the throttled build loops of this thread sleep ``yield_s``
    after each bounded step while the block is active (and, with ``busy``,
    only while foreground work exists).

    A build step ends with a sync of the building thread's own stream, so
    the card holds at most one step of the build at a time; the sleep then
    hands the host's core and the interpreter lock to a waiting query lane
    before the next step is queued, so a query batch runs with most of the
    host instead of convoying behind the whole build. ``busy`` (a nullary
    predicate, e.g. "any query in flight") gates each sleep, so an
    unloaded build runs at full speed. The setting is per thread: the
    scheduler's ingest lane sets it around whole mutations, several layers
    above the loops it gates."""
    prev = getattr(_COOPERATIVE, "state", (0.0, None))
    _COOPERATIVE.state = (float(yield_s), busy)
    try:
        yield
    finally:
        _COOPERATIVE.state = prev


def _yield_slot() -> None:
    """One cooperative yield point between bounded build steps (a no-op
    outside ``cooperative_build``, or when its ``busy`` predicate says no
    foreground work is waiting)."""
    yield_s, busy = getattr(_COOPERATIVE, "state", (0.0, None))
    if yield_s > 0.0 and (busy is None or busy()):
        time.sleep(yield_s)


def sync_devices(devices) -> None:
    """Wait for the current stream (the calling lane's own work) of every
    card among ``devices``: a mesh store's home and slots."""
    for dev in dict.fromkeys(torch.device(d) for d in devices):
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


def _step_done(device: torch.device) -> None:
    """End one bounded build step: wait for the current stream (the
    building lane's own, never the whole card), then yield."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    _yield_slot()


def _sort_tables_throttled(keys_t: torch.Tensor):
    """``_sort_tables`` one table at a time, the stream synchronized after
    each: the same values (tables sort independently), so the fold's sort
    never queues one all-tables step ahead of a concurrent query."""
    outs = []
    for table in range(keys_t.shape[-2]):
        outs.append(_sort_tables(keys_t[..., table:table + 1, :]))
        _step_done(keys_t.device)
    perm = torch.cat([o[0] for o in outs], dim=-2)
    sorted_keys = torch.cat([o[1] for o in outs], dim=-2)
    return perm, sorted_keys, torch.stack([o[2] for o in outs]).max()


def _scatter_rows_chunk(buf: torch.Tensor, src: torch.Tensor,
                        src_idx: torch.Tensor, dst_idx: torch.Tensor) -> None:
    """One bounded step of the chunked copy: rows ``src_idx`` of ``src``
    into rows ``dst_idx`` of ``buf``, in place (O(chunk), not O(buffer))."""
    buf.index_copy_(0, dst_idx, src.index_select(0, src_idx))


def gather_rows_chunked(template: torch.Tensor, srcs, src_idxs, dst_idxs,
                        out_rows: int, *, chunk: int = 4096) -> torch.Tensor:
    """Assemble ``out_rows`` rows into a fresh zero buffer of
    ``template``'s row shape and dtype by bounded gather + scatter steps.

    The one-pass folds (``_slab_gather_sort``, ``effective_arrays``) move
    the whole store in one step; on the card a query queued on another
    stream then shares the device with the whole copy. This path copies at
    most ``chunk`` rows a step from each source and synchronizes its own
    stream after every step, so the card holds one chunk of the build at
    a time and query kernels interleave between chunks. Every live row is
    written exactly once and the others stay zero, so the values equal the
    one-pass gather's (whose pad rows are zeros).

    ``srcs`` are (rows, ...) tensors with a flat leading axis;
    ``src_idxs`` / ``dst_idxs`` the matching host (numpy) row maps into
    them and into the output."""
    dev = template.device
    buf = template.new_zeros((out_rows,) + tuple(template.shape[1:]))
    for src, s_idx, d_idx in zip(srcs, src_idxs, dst_idxs):
        s_all = torch.from_numpy(np.asarray(s_idx, np.int64)).to(dev)
        d_all = torch.from_numpy(np.asarray(d_idx, np.int64)).to(dev)
        for c0 in range(0, s_all.shape[0], chunk):
            _scatter_rows_chunk(buf, src, s_all[c0:c0 + chunk],
                                d_all[c0:c0 + chunk])
            _step_done(dev)
    return buf


def _slab_gather_sort_chunked(keys, stacked, idx: np.ndarray, counts, *,
                              shard_size: int, chunk: int):
    """``_slab_gather_sort`` in bounded steps, each ending with a sync of
    the current stream: the keys gathered in one step (a few bytes an item,
    ``_slab_gather_keys``), each table sorted on its own
    (``_sort_shard_table``), and the corpus copied in chunks of flat
    (shard * slot) rows (``gather_rows_chunked``). ``idx`` is the host
    (S, shard_size) slot map; the other arguments and the outputs, bit for
    bit, are ``_slab_gather_sort``'s."""
    dev = counts.device
    keys_n = _slab_gather_keys(torch.cat(list(keys), dim=1),
                               torch.from_numpy(idx).to(dev))
    _step_done(dev)
    tables = []
    for table in range(keys_n.shape[-1]):
        tables.append(_sort_shard_table(keys_n[:, :, table], counts,
                                        shard_size=shard_size))
        _step_done(dev)
    s = idx.shape[0]
    sh_i, col_i = np.nonzero(idx < sum(g.shape[1] for g in stacked))
    src_of = idx[sh_i, col_i]               # the pads (W) drop out above
    srcs, src_idxs, dst_idxs = [], [], []
    off = 0
    for g in stacked:
        wg = g.shape[1]
        m = (src_of >= off) & (src_of < off + wg)
        srcs.append(g.flatten(0, 1))
        src_idxs.append(sh_i[m] * wg + src_of[m] - off)
        dst_idxs.append(sh_i[m] * shard_size + col_i[m])
        off += wg
    out = gather_rows_chunked(srcs[0], srcs, src_idxs, dst_idxs,
                              s * shard_size, chunk=chunk)
    return (keys_n, torch.stack([t[1] for t in tables], dim=1),
            torch.stack([t[0] for t in tables], dim=1),
            out.unflatten(0, (s, shard_size)),
            torch.stack([t[2] for t in tables]).amax(0))


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


def _live_window_tables_sharded(perm: torch.Tensor, live: torch.Tensor):
    """Sharded ``_live_window_tables``: perm (S, L, n_s) + live (S, n_s+1)
    -> (live_rank (S, L, n_s+1), live_pos (S, L, n_s)) int32, every
    (shard, table) in one pass. Shards and tables are independent integer
    scans and stable sorts, so the values are the per-table build's."""
    s, nt, n = perm.shape
    live_sorted = torch.gather(live[:, None, :].expand(s, nt, n + 1), 2,
                               perm.long())
    rank = torch.cat([torch.zeros((s, nt, 1), dtype=torch.int32,
                                  device=live.device),
                      torch.cumsum(live_sorted, -1, dtype=torch.int32)],
                     dim=-1)
    pos = torch.argsort((~live_sorted).to(torch.uint8), dim=-1, stable=True)
    return rank, pos.to(torch.int32)


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
    .segment_table``) in ``k1_segments`` order, built once per view: the
    segments for a single-device store, every (shard, segment) pair,
    shard-major, for a sharded one.

    On the card ``ready`` is an event recorded on the publishing stream
    after the view's last upload (its lookups and K1 table); a reader
    takes the view through ``acquire``.

    A mesh store's view holds ``slots``: per slot a view over the blocks
    of every segment (the slot's one-shard base block and slab blocks, its
    lookups and its own K1 table), on the slot's device. The mesh view's
    ``segments`` / ``luts`` / ``wins`` are the store's (each segment's
    lookups per slot), and its ``ready`` maps every device of the slots to
    an event recorded there after the slots' uploads."""

    segments: tuple          # base + deltas, slot-offset order
    luts: tuple              # per segment (live (m+1,), eff (m,))
    wins: tuple              # per segment live-window lookups (or None)
    generation: int = 0
    ready: object = dataclasses.field(default=None, compare=False,
                                      repr=False)
    # the streams (``cuda_stream`` handles) the arrays were marked on
    pinned: set = dataclasses.field(default_factory=set, compare=False,
                                    repr=False)
    slots: tuple = ()        # a mesh store's per-slot views

    @property
    def device(self) -> torch.device:
        """The view's device (a mesh view's: its home)."""
        base = self.base
        return base.home if base.blocks else base.keys.device

    def tensors(self):
        """Every device array the view's queries read."""
        if self.slots:
            for slot in self.slots:
                yield from slot.tensors()
            return
        for seg in self.segments:
            yield seg.keys
            yield seg.sorted_keys
            yield seg.perm
            yield seg.stacked
            yield from seg.corpus.leaves
        for lut in self.luts:
            yield from lut
        for win in self.wins:
            if win is not None:
                yield from win
        table = self.__dict__.get("k1_table")
        if table is not None:
            yield table.desc

    def acquire(self) -> "StoreView":
        """Ready the view for work on the current stream -> the view.

        On the card the current stream waits on ``ready`` (the view's
        uploads on the publishing stream), and the first time a stream
        reads the view, each array is marked as in use on it
        (``Tensor.record_stream``; a no-op on the array's own stream). When
        the view's store is replaced (``apply_swap``) or the view
        superseded, the caching allocator then hands that memory out again
        only after the work this stream had queued by the time the arrays
        were freed has run: a query in flight never reads a store whose
        memory was reused. A mesh view does this on each device of its
        slots, with that device's current stream and event. A no-op on
        the CPU."""
        if self.ready is None:
            return self
        events = (self.ready if self.slots
                  else {self.base.keys.device: self.ready})
        for dev, event in events.items():
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(event)
            handle = stream.cuda_stream
            if handle not in self.pinned:
                for t in self.tensors():
                    if t.device == dev:
                        t.record_stream(stream)
                self.pinned.add(handle)
        return self

    @property
    def base(self) -> TableSegment | ShardedSegment:
        return self.segments[0]

    @property
    def sharded(self) -> bool:
        return isinstance(self.base, ShardedSegment)

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
    def k1_segments(self) -> tuple[tuple, tuple]:
        """(segment arrays, caps) in the order K1 walks them."""
        if self.slots:
            raise ValueError("a mesh view's K1 segments are its slots'")
        if not self.sharded:
            return self.all_arrays, self.all_caps
        from repro_torch.kernels.fused_query import shard_segments
        return shard_segments(self.seg_arrays(0), self.delta_arrays,
                              self.base.cap, self.delta_caps)

    @functools.cached_property
    def k1_table(self):
        from repro_torch.kernels.fused_query import segment_table
        return segment_table(*self.k1_segments)


def _flat(seg):
    """A one-device segment's (corpus-order keys, corpus) with any shard
    dim flattened into its slot order."""
    if isinstance(seg, ShardedSegment):
        return seg.keys.flatten(0, 1), seg.flat_corpus
    return seg.keys, seg.corpus


def _cat_corpus(corpora):
    """Batched tensors of one format, rank and scale -> one."""
    first = corpora[0]
    if len(corpora) == 1:
        return first
    if any(c.scale != first.scale for c in corpora):
        raise ValueError("segments of one store hold corpora of different "
                         "scales; they cannot be folded into one")
    return first.with_leaves(torch.cat(ls) for ls in
                             zip(*(c.leaves for c in corpora)))


class SegmentStore:
    """LSM-style mutable view over immutable segments (reference:
    ``repro.core.segments.SegmentStore``; its sharded segments on one
    device or as per-slot blocks over a mesh).

    One base segment (``TableSegment``, or ``ShardedSegment`` for the
    sharded store), a list of delta segments (``TableSegment``s, or routed
    ``ShardedSegment`` slabs), a host tombstone mask over every slot (shard
    pads are born dead), and per segment a host ``slot_pos`` map from slot
    to sequence position (-1 for pads): routed slabs interleave shards, so
    slot order is not arrival order. ``base_pos`` overrides the base's map
    (a shard-local compaction leaves shards holding non-contiguous sequence
    ranges). Every mutation ends by re-deriving the per-segment device
    lookups and publishing a fresh ``StoreView`` (one attribute write):
    ``live`` (m+1,) bool, ``eff`` (m,) int32 (the slot's effective id) and,
    with ``live_window``, the (live_rank, live_pos) tables; sharded
    segments get them per shard.
    """

    def __init__(self, base, *, base_pos: np.ndarray | None = None,
                 live_window: bool = False):
        self.base = base
        self.deltas: list = []
        self.live_window = bool(live_window)
        self._generation = 0
        if base_pos is None:
            real = np.ones(base.slots, bool)
            if isinstance(base, ShardedSegment):
                n_s = base.shard_size
                real = (np.arange(n_s)[None, :]
                        < np.asarray(base.counts)[:, None]).reshape(-1)
            base_pos = np.where(real, np.cumsum(real) - 1, -1)
        self.slot_pos = [np.asarray(base_pos, np.int64)]
        self.live_host = self.slot_pos[0] >= 0
        self.seq_len = int(base.items)
        self._refresh()

    @property
    def device(self) -> torch.device:
        """The home device: where the store's gathers land."""
        base = self.base
        return base.home if base.blocks else base.keys.device

    @property
    def devices(self) -> tuple:
        """Every device the store's arrays lie on, the home device first."""
        return tuple(dict.fromkeys((self.device,) + self.base.devices))

    # -- derived state ------------------------------------------------------

    def _segments(self) -> list:
        return [self.base] + self.deltas

    def _seg_luts(self, seg, live: np.ndarray, eff: np.ndarray):
        """A segment's (live, eff) lookups; a mesh segment's per slot, each
        on the slot's device."""
        dev = self.device
        if isinstance(seg, ShardedSegment):
            s, n_s = seg.shards, seg.shard_size
            live = np.pad(live.reshape(s, n_s), ((0, 0), (0, 1)))
            eff = eff.reshape(s, n_s).astype(np.int32)
            if seg.blocks:
                return tuple((torch.from_numpy(live[i:i + 1]).to(d),
                              torch.from_numpy(eff[i:i + 1]).to(d))
                             for i, d in enumerate(seg.devices))
            return (torch.from_numpy(live).to(dev),
                    torch.from_numpy(eff).to(dev))
        return (torch.from_numpy(np.append(live, False)).to(dev),
                torch.from_numpy(eff.astype(np.int32)).to(dev))

    def _seg_win(self, seg, lut):
        """A segment's live-window lookups from its ``_seg_luts``; a mesh
        segment's per slot, on the slot's device."""
        if not self.live_window:
            return None
        if isinstance(seg, ShardedSegment):
            if seg.blocks:
                return tuple(_live_window_tables_sharded(b.perm, bl[0])
                             for b, bl in zip(seg.blocks, lut))
            return _live_window_tables_sharded(seg.perm, lut[0])
        return _live_window_tables(seg.perm, lut[0])

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
            lut = self._seg_luts(seg, live, eff)
            luts.append(lut)
            if touched is None or i in touched:
                wins.append(self._seg_win(seg, lut))
            else:
                wins.append(self._wins[i])
            off += seg.slots
        self._luts, self._wins = luts, wins
        self._publish()

    def _publish(self) -> None:
        """Assemble and install a fresh immutable view (one attribute
        write). On the card its K1 table is uploaded here, not per query,
        and the view's ``ready`` event is recorded on the current stream
        after that upload, before the view is installed."""
        self._generation += 1
        cuda = self.device.type == "cuda"
        segs = tuple(self._segments())
        if self.base.blocks:
            self.view = self._mesh_view(segs, cuda)
            return
        view = StoreView(segments=segs,
                         luts=tuple(self._luts), wins=tuple(self._wins),
                         generation=self._generation,
                         ready=torch.cuda.Event() if cuda else None)
        if cuda:
            _ = view.k1_table       # uploaded now, not by the next query
            view.ready.record(torch.cuda.current_stream(self.device))
        self.view = view

    def _mesh_view(self, segs, cuda: bool) -> StoreView:
        """A mesh store's view: one view a slot over its blocks, each K1
        table uploaded to the slot's device, then an event recorded on the
        current stream of every device the slots use."""
        slots = tuple(
            StoreView(segments=tuple(g.blocks[s] for g in segs),
                      luts=tuple(lut[s] for lut in self._luts),
                      wins=tuple(None if w is None else w[s]
                                 for w in self._wins),
                      generation=self._generation)
            for s in range(self.base.shards))
        ready = ({d: torch.cuda.Event() for d in self.base.devices}
                 if cuda else None)
        view = StoreView(segments=segs, luts=tuple(self._luts),
                         wins=tuple(self._wins), generation=self._generation,
                         ready=ready, slots=slots)
        if cuda:
            for slot in slots:
                _ = slot.k1_table
            for dev, event in ready.items():
                event.record(torch.cuda.current_stream(dev))
        return view

    @property
    def generation(self) -> int:
        """Monotone mutation clock: bumps whenever a new view publishes."""
        return self.view.generation

    def seg_arrays(self, i: int) -> SegmentArrays:
        return self.view.seg_arrays(i)

    @property
    def mutated(self) -> bool:
        return bool(self.deltas) or self.n_dead > 0

    @property
    def shard_live_counts(self) -> np.ndarray | None:
        """(S,) live items per shard over the base and every slab: the
        occupancy the routing balances (None for a single-device store)."""
        counts, off = None, 0
        for seg in self._segments():
            live = self.live_host[off:off + seg.slots]
            if isinstance(seg, ShardedSegment):
                c = live.reshape(seg.shards, seg.shard_size).sum(axis=1)
                counts = c.astype(np.int64) if counts is None else counts + c
            off += seg.slots
        return counts

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

    def append_delta(self, seg, positions: np.ndarray | None = None) -> None:
        """O(batch) append: the new items take the next sequence positions
        and effective ids (after every live item), so earlier segments'
        lookups are untouched and only the new segment's are built.
        ``positions`` maps the segment's slots to sequence positions (-1
        for pads; ``build_sharded_delta`` makes it), by default the next
        ones in slot order."""
        seq0, slots0 = self.seq_len, self.live_host.size
        if positions is None:
            positions = np.arange(seq0, seq0 + seg.slots)
        positions = np.asarray(positions, np.int64)
        valid = positions >= 0
        n_new = int(valid.sum())
        start = self.n_live
        self.deltas.append(seg)
        self.slot_pos.append(positions)
        self.live_host = np.concatenate([self.live_host, valid])
        self._live_seq = np.concatenate([self._live_seq,
                                         np.ones(n_new, bool)])
        p2s = np.full(n_new, -1, np.int64)
        p2s[positions[valid] - seq0] = slots0 + np.flatnonzero(valid)
        self._pos_to_slot = np.concatenate([self._pos_to_slot, p2s])
        eff = np.where(valid, start + (positions - seq0), 0)
        self.seq_len += n_new
        self.n_live += n_new
        lut = self._seg_luts(seg, valid, eff)
        self._luts.append(lut)
        self._wins.append(self._seg_win(seg, lut))
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

    def _mesh_rows(self, idx: np.ndarray, name: str,
                   chunk: int | None = None) -> torch.Tensor:
        """A mesh store's rows ``idx`` (flat slot indices over every
        segment) of the blocks' ``name`` arrays ("keys" or "stacked"),
        gathered a slot at a time on the slot's device (in bounded chunks,
        ``gather_rows_chunked``, with ``chunk``), then copied home into
        ``idx``'s order."""
        segs = self._segments()
        offs = np.cumsum([0] + [g.slots for g in segs[:-1]])
        out = None
        for s, dev in enumerate(self.base.devices):
            srcs, src_idxs, dst_idxs = [], [], []
            for off, g in zip(offs, segs):
                lo = off + s * g.shard_size
                dst = np.flatnonzero((idx >= lo) & (idx < lo + g.shard_size))
                srcs.append(getattr(g.blocks[s], name)[0])
                src_idxs.append(idx[dst] - lo)
                dst_idxs.append(dst)
            dst = np.concatenate(dst_idxs)
            if chunk is None:
                rows = torch.cat([
                    src[torch.from_numpy(si).to(dev)]
                    for src, si in zip(srcs, src_idxs)])
            else:
                local = np.cumsum([0] + [d.size for d in dst_idxs])
                rows = gather_rows_chunked(
                    srcs[0], srcs, src_idxs,
                    [np.arange(a, b) for a, b in zip(local, local[1:])],
                    dst.size, chunk=chunk)
            if out is None:
                out = srcs[0].new_zeros((idx.size,) + srcs[0].shape[1:],
                                        device=self.device)
            out[torch.from_numpy(dst).to(self.device)] = rows.to(self.device)
        return out

    def effective_arrays(self):
        """-> ((n_live, L) keys, corpus) of the live items in sequence (=
        effective id) order, one gather each: the input of a compaction or
        a rebalance. Keys come from storage, never from re-hashing. A mesh
        store gathers a slot at a time and lands both on its home
        device."""
        if self.base.blocks:
            idx = self._live_slots_seq_order()
            stacked = self._mesh_rows(idx, "stacked")
            return (self._mesh_rows(idx, "keys"),
                    unstack_like(self.base.blocks[0].corpus, stacked))
        flats = [_flat(seg) for seg in self._segments()]
        idx = torch.from_numpy(self._live_slots_seq_order()).to(self.device)
        keys = torch.cat([k for k, _ in flats])[idx]
        return keys, _cat_corpus([c for _, c in flats]).index(idx)

    def effective_arrays_chunked(self, chunk: int):
        """``effective_arrays`` with the corpus assembled by bounded gather
        + scatter steps (``gather_rows_chunked``) in the kernels' stacked
        layout -> (keys, corpus, stacked): ``corpus`` views ``stacked``,
        whose values equal the one-pass gather's stacked corpus bit for
        bit. The keys stay one step: a few bytes an item."""
        idx = self._live_slots_seq_order()
        if self.base.blocks:
            keys = self._mesh_rows(idx, "keys")
            _step_done(self.device)
            stacked = self._mesh_rows(idx, "stacked", chunk=chunk)
            return (keys, unstack_like(self.base.blocks[0].corpus, stacked),
                    stacked)
        flat_keys, srcs, src_idxs, dst_idxs = [], [], [], []
        off = 0
        for seg in self._segments():
            flat_keys.append(_flat(seg)[0])
            srcs.append(seg.stacked.flatten(0, 1)
                        if isinstance(seg, ShardedSegment) else seg.stacked)
            dst = np.flatnonzero((idx >= off) & (idx < off + seg.slots))
            src_idxs.append(idx[dst] - off)
            dst_idxs.append(dst)
            off += seg.slots
        keys = torch.cat(flat_keys)[torch.from_numpy(idx).to(self.device)]
        _step_done(self.device)
        stacked = gather_rows_chunked(srcs[0], srcs, src_idxs, dst_idxs,
                                      idx.size, chunk=chunk)
        return keys, unstack_like(self.base.corpus, stacked), stacked

    def effective_corpus(self):
        """The live corpus in effective-id order: the base's own for a
        pristine single-device store, a slice when the live slots are a
        prefix in sequence order (a pristine sharded base), one gather
        otherwise."""
        if not self.mutated and isinstance(self.base, TableSegment):
            return self.base.corpus
        idx = self._live_slots_seq_order()
        if self.base.blocks:
            return unstack_like(self.base.blocks[0].corpus,
                                self._mesh_rows(idx, "stacked"))
        corpus = _cat_corpus([_flat(seg)[1] for seg in self._segments()])
        if np.array_equal(idx, np.arange(idx.size)):
            return corpus.index(slice(0, idx.size))
        return corpus.index(torch.from_numpy(idx).to(self.device))


# ---------------------------------------------------------------------------
# Re-rank and the query planner
# ---------------------------------------------------------------------------


def hoisted_scores(metric: str, queries, corpus, safe: torch.Tensor,
                   chunk: int = 64) -> torch.Tensor:
    """Exact re-rank scores of gathered candidates (``safe`` is the (B, W)
    clamped candidate matrix): <Y, Y> per corpus item once in the corpus's
    format, <Q, Q> per query in the query's, <Q, Y> per (query, candidate)
    across the two (``contractions.pair_inners``: CP Grams, the TT chain, a
    dot, or a cross-format contraction), ``chunk`` queries at a time so
    that the gathered (chunk, W) rows bound the memory, combined in the
    reference's expression and order: sqrt(max(qq + yy - 2 qy, 0)) or
    qy / (nq * ny)."""
    yy = corpus.self_inners()                             # (m,)
    qq = queries.self_inners()                            # (B,)
    qy = torch.cat([
        contractions.pair_inners(
            queries.index(slice(s, s + chunk)).index((slice(None), None)),
            corpus.index(safe[s:s + chunk]))
        for s in range(0, max(safe.shape[0], 1), chunk)], dim=0)  # (B, W)
    if metric == "euclidean":
        d2 = qq[:, None] + yy[safe] - 2.0 * qy
        return torch.sqrt(torch.clamp(d2, min=0.0))
    nq = torch.sqrt(torch.clamp(qq, min=0.0))
    ny = torch.sqrt(torch.clamp(yy, min=0.0))
    return qy / (nq[:, None] * ny[safe])


def segmented_query(family, segs, mults, queries, *, metric: str,
                    topk: int, caps, probes: int = 1, table=None,
                    mode: str = "topk", key=None):
    """From a query batch to ((B, topk) effective ids, (B, topk) scores,
    (B,) candidate counts) over every segment (``segs`` in slot-offset
    order, ``caps`` their probe widths): the batch is stacked once, K3 or
    K4 (``raw`` epilogue) projects it, and one K1 launch expands each
    table's key to ``probes`` ranked keys, probes every segment and selects.
    ``table`` is the view's ``k1_table`` (built once per view on the
    card); ``mode`` / ``key`` as ``segmented_sample``."""
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
                       caps=caps, probes=probes, table=table, mode=mode,
                       key=key)


def segmented_sample(family, segs, mults, queries, key, *, metric: str,
                     topk: int, caps, probes: int = 1, mode: str,
                     table=None):
    """The sampling variant of ``segmented_query`` (reference:
    ``segmented_sample``): the batch is hashed once (K3 / K4, ``raw``) and
    one K1 launch in sample ``mode`` ("uniform" or "weighted") draws
    ``topk`` distinct members of each query's probed union over every
    segment, uniformly or in proportion to their raw hit counts, by Gumbel
    top-k under the draw's two uint32 ``key`` words (each query row's noise
    its own); -> (ids (B, topk), exact scores (B, topk), the union's size
    (B,)) in ``segmented_query``'s order and fill."""
    if mode not in ("uniform", "weighted"):
        raise ValueError(f"unknown sampling mode {mode!r}")
    return segmented_query(family, segs, mults, queries, metric=metric,
                           topk=topk, caps=caps, probes=probes, table=table,
                           mode=mode, key=key)


def sharded_query(family, base, deltas, mults, queries, *, metric: str,
                  topk: int, cap: int, delta_caps, probes: int = 1,
                  table=None, mode: str = "topk", key=None):
    """The sharded planner (reference: ``sharded_query_vmap``, which vmaps
    the per-shard probe over the shard dim on one device; nothing is
    vmapped here): from a query batch to ((B, topk) effective ids, scores,
    (B,) candidate counts) over every (shard, segment) pair. The batch is
    stacked once, K3 or K4 (``raw`` epilogue) projects it once, and one K1s
    launch (``kernels.fused_query.fused_query_sharded``) probes every
    shard's base slice and delta slabs with one running top-k, which takes
    the place of the reference's S-way merge. ``base`` / ``deltas`` are
    the sharded segments' arrays (leading shard dim), ``table`` the view's
    ``k1_table``; ``mode`` / ``key`` as ``sharded_sample``."""
    from repro_torch.kernels.fused_query import fused_query_sharded
    from repro_torch.kernels.ops import mults_tensor

    family.check_inputs(queries)
    queries = queries.stack()
    values = family.raw_stacked(queries[1], queries[0].scale)
    return fused_query_sharded(
        values, family.offsets, mults_tensor(mults, values.device), queries,
        base, deltas, kind=family.kind, w=family.bucket_width,
        num_tables=family.num_tables, num_codes=family.num_codes,
        metric=metric, topk=topk, cap=cap, delta_caps=delta_caps,
        probes=probes, table=table, mode=mode, key=key)


def sharded_sample(family, base, deltas, mults, queries, key, *,
                   metric: str, topk: int, cap: int, delta_caps,
                   probes: int = 1, mode: str, table=None):
    """The sampling variant of ``sharded_query`` (reference:
    ``sharded_sample_vmap``): one K1s launch in sample ``mode`` draws from
    the union over every (shard, segment) pair. Effective ids are unique
    across shards and the noise is keyed by them, so a key draws the same
    sample as ``segmented_sample`` over the same live corpus."""
    if mode not in ("uniform", "weighted"):
        raise ValueError(f"unknown sampling mode {mode!r}")
    return sharded_query(family, base, deltas, mults, queries, metric=metric,
                         topk=topk, cap=cap, delta_caps=delta_caps,
                         probes=probes, table=table, mode=mode, key=key)


def segment_candidates(seg, keys, cap) -> tuple[torch.Tensor, torch.Tensor]:
    """One segment's probe of (L, T, B) ``keys`` -> (cand (B, L*T*cap)
    effective ids with -1 fill, valid (B, L*T*cap) bool): every distinct
    live member of the probed windows once (``fused_query.segment_windows``,
    the window arithmetic of K1's plain version), mapped through the
    segment's ``eff``."""
    from repro_torch.kernels.fused_query import segment_windows
    cand, valid = segment_windows(seg, keys, cap)
    safe = torch.where(valid, cand, 0).long()
    return torch.where(valid, seg.eff[safe], -1), valid


def _cat_candidates(parts) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.cat([c for c, _ in parts], dim=1),
            torch.cat([v for _, v in parts], dim=1))


def segmented_candidates(family, segs, mults, queries, *, caps,
                         probes: int = 1):
    """The candidate sets of a query batch over every segment (``segs`` in
    slot-offset order, ``caps`` their probe widths) -> (cand (B, W)
    effective ids with -1 fill, valid (B, W) bool), the segments
    concatenated; tombstones never appear. The keys are K1's own
    (``k1_probe_keys``), so each row's valid count is the ``n_candidates``
    that ``segmented_query`` returns. Plain PyTorch on the tensors' device:
    the reference computes these without a kernel too."""
    keys = k1_probe_keys(family, mults, queries, probes)
    return _cat_candidates([segment_candidates(seg, keys, cap)
                            for seg, cap in zip(segs, caps)])


def sharded_candidates(family, base, deltas, mults, queries, *, cap: int,
                       delta_caps, probes: int = 1):
    """``segmented_candidates`` over a sharded store: every (shard,
    segment) pair in K1s's order (``fused_query.shard_segments``), ``base``
    / ``deltas`` the sharded segments' arrays (leading shard dim)."""
    from repro_torch.kernels.fused_query import shard_segments
    keys = k1_probe_keys(family, mults, queries, probes)
    segs, caps = shard_segments(base, deltas, cap, delta_caps)
    return _cat_candidates([segment_candidates(seg, keys, c)
                            for seg, c in zip(segs, caps)])
