"""Mesh placement and the mesh query program of ``ShardedLSHIndex``
(reference: ``repro.distributed.index_sharding``).

The index math (per-segment probe, re-rank, top-k) lives in
``core.segments`` and K1s (``kernels.fused_query.fused_query_sharded``);
this module decides *where* the sharded segments lie and runs the query
over them. One process drives every slot of the mesh, as the reference's
one controller drives its local devices: there is no
``torch.distributed`` here.

- ``resolve_mesh``: map a shard count to (mesh, axis). An active
  ``distributed.sharding.axis_rules`` context wins when its ``lsh_shard``
  rule resolves to one mesh axis of size S. Without a context, the first S
  local devices of the index's device type form a 1-D ``shard`` mesh (the
  CPU counts as one device). With fewer devices than shards, or a context
  whose rule does not fit, the index keeps its one-device layout.
- ``place_sharded`` / ``place_shadow``: shard ``s`` of a sharded segment
  goes to slot ``s`` of the mesh axis: the ``ShardedSegment`` becomes
  per-slot blocks (``segments.place_blocks``), each in its own memory on
  its slot's device. Under a 2-D mesh a slot is the first device of its
  slice of the axis: in one process a replica along the other axis would
  hold the same bytes and serve nothing. ``place_shadow`` also waits for
  the copies, so a swap publishes a fully placed store.
- ``shard_map_query``: hash once on the home device (K3 / K4 / the dense
  hash), copy the raw values and the stacked queries to each slot's
  device, launch K1s once per slot over that slot's (shard, segment)
  pairs on the slot's device and current stream, bring the S per-slot
  (B, topk) results home and merge them with one ``packed_select`` keyed
  by (validity, score, effective id). That order is strict, and K1 scores
  a candidate from its row and the query alone, so the merge equals the
  one-launch K1s over every pair bit for bit. The sampling modes draw per
  slot and merge by the draw's own key (``merge_sample``): the noise is
  keyed by (query row, effective id) and an item's hit count is local to
  its shard, so the first ``topk`` of the union are the first ``topk`` of
  the slots' draws.
- ``shard_map_candidates``: each slot's candidate sets on its device, in
  the one-device order (slot-major, base block then slabs).

The reference's ``shard_map_query_reference`` has no counterpart: on the
CPU each slot runs K1s's plain version (``fused_query_sharded_plain``),
which holds the per-slot program to the one-device one.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import segments
from repro_torch.distributed import sharding
from repro_torch.kernels import epilogues as _epi

# Logical dim name of the corpus-shard axis (sharding.DEFAULT_RULES) and
# the axis name of the 1-D mesh this module builds itself.
SHARD_LOGICAL = "lsh_shard"
SHARD_AXIS = "shard"


def resolve_mesh(shards: int, device
                 ) -> tuple[sharding.Mesh, str] | tuple[None, None]:
    """-> (mesh, axis name) to lay an S-sharded index on ``device`` over,
    or (None, None) for the one-device layout.

    Inside an ``axis_rules`` context the ``lsh_shard`` rule must resolve to
    one mesh axis whose size equals ``shards``; otherwise a 1-D mesh over
    the first ``shards`` local devices of ``device``'s type is built."""
    ctx = sharding.current()
    if ctx is not None:
        axes = ctx.rules.get(SHARD_LOGICAL)
        if axes and len(axes) == 1 and ctx.mesh.shape[axes[0]] == shards:
            return ctx.mesh, axes[0]
        return None, None
    dev = torch.device(device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [torch.device("cpu")])
    if shards <= len(devices):
        return sharding.Mesh(devices[:shards], (SHARD_AXIS,)), SHARD_AXIS
    return None, None


def slot_devices(mesh: sharding.Mesh, axis: str) -> list[torch.device]:
    """The device of each slot along ``axis``: the first device of the
    mesh's slice at that index."""
    arr = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return [torch.device(d) for d in arr.reshape(arr.shape[0], -1)[:, 0]]


def check_slots(mesh: sharding.Mesh, axis: str, home) -> None:
    """Refuse a mesh whose slots are not devices of the index's type, or
    a slot whose device this process cannot use: there is no fallback to
    the one-device layout."""
    home = torch.device(home)
    for dev in slot_devices(mesh, axis):
        if dev.type != home.type:
            raise ValueError(f"a mesh slot on {dev} for an index on {home}")
        if dev.type == "cuda" and not (
                torch.cuda.is_available()
                and (dev.index or 0) < torch.cuda.device_count()):
            raise RuntimeError(f"mesh slot {dev} is not available")


def place_sharded(seg: segments.ShardedSegment, mesh: sharding.Mesh,
                  axis: str) -> segments.ShardedSegment:
    """Lay a one-device sharded segment's leading shard dim over ``axis``:
    its per-slot blocks (``segments.place_blocks``), shard ``s`` on slot
    ``s``."""
    return segments.place_blocks(seg, slot_devices(mesh, axis))


def place_shadow(seg: segments.ShardedSegment, mesh: sharding.Mesh,
                 axis: str) -> segments.ShardedSegment:
    """``place_sharded`` for a swap's shadow store: the copies are issued
    and waited for here, off the query path, so the later flip publishes
    a store whose every block has landed on its slot."""
    placed = place_sharded(seg, mesh, axis)
    segments.sync_devices(placed.devices)
    return placed


def _on(t, dev):
    return None if t is None else t.to(dev)


def _slot_queries(values, x, q, dev):
    """The raw values and the (format, stacked) query pair on ``dev``: the
    stacked batch copied once, the format's leaves views of the copy."""
    from repro_torch.kernels.ops import unstack_like
    if q.device == torch.device(dev):
        return values, (x, q)
    q = q.to(dev)
    return values.to(dev), (unstack_like(x, q), q)


def _slot_pairs(slot):
    """A slot view's (shard, segment) pairs and caps, in K1s's order."""
    from repro_torch.kernels.fused_query import shard_segments
    return shard_segments(slot.seg_arrays(0), slot.delta_arrays,
                          slot.base.cap, slot.delta_caps)


def shard_map_query(family, view, mults, queries, *, metric: str,
                    topk: int, probes: int = 1, mode: str = "topk",
                    key=None):
    """One query batch over a mesh store's ``view`` -> ((B, topk) effective
    ids, (B, topk) scores, (B,) candidate counts) on the home device: the
    batch stacked and hashed once (``family.raw_stacked``), then one K1s
    launch a slot (``fused_query_sharded`` over the slot's base block and
    slab blocks, with the slot's K1 table), then ``merge_topk`` (or
    ``merge_sample`` for the sampling ``mode``s, with the draw's ``key``
    words)."""
    from repro_torch.kernels.fused_query import (fused_query_sharded,
                                                 probe_keys_from_values)
    from repro_torch.kernels.ops import mults_tensor

    family.check_inputs(queries)
    x, q = queries.stack()
    values = family.raw_stacked(q, x.scale)
    home = values.device
    mults = mults_tensor(mults, home)
    kw = dict(kind=family.kind, w=family.bucket_width,
              num_tables=family.num_tables, num_codes=family.num_codes)
    probe_keys = (probe_keys_from_values(
        values, family.offsets, mults, e2=family.kind.endswith("e2lsh"),
        w=family.bucket_width, num_tables=family.num_tables,
        num_codes=family.num_codes, probes=probes)
        if mode == "weighted" else None)
    outs, hits = [], []
    for slot in view.slots:
        dev = slot.device
        v, xq = _slot_queries(values, x, q, dev)
        ids, scores, n_cand = fused_query_sharded(
            v, _on(family.offsets, dev), mults.to(dev), xq,
            slot.seg_arrays(0), slot.delta_arrays, metric=metric, topk=topk,
            cap=slot.base.cap, delta_caps=slot.delta_caps, probes=probes,
            table=slot.k1_table, mode=mode, key=key, **kw)
        if probe_keys is not None:
            hits.append(drawn_hits(slot, probe_keys.to(dev), ids).to(home))
        outs.append((ids.to(home), scores.to(home), n_cand.to(home)))
    ids, scores, n_cand = (torch.stack(part) for part in zip(*outs))
    if mode == "topk":
        return merge_topk(metric, topk, ids, scores, n_cand)
    return merge_sample(metric, topk, mode, key, ids, scores, n_cand,
                        torch.stack(hits) if hits else None)


def _flat_slots(t: torch.Tensor) -> torch.Tensor:
    """(S, B, k) -> (B, S * k), slot-major within each row."""
    s, b, k = t.shape
    return t.permute(1, 0, 2).reshape(b, s * k)


def merge_topk(metric: str, topk: int, ids, scores, n_cand):
    """(S, B, k) per-slot top-k -> the global (ids, scores, n_cand): the
    slots' rows concatenated and one ``packed_select`` over their (order
    key, effective id) keys, the strict order every K1 selection uses, so
    the merge equals one selection over every candidate."""
    flat_ids = _flat_slots(ids)
    hi, lo = _epi.pack_candidates(metric, flat_ids, _flat_slots(scores),
                                  flat_ids >= 0)
    out_ids, out_scores = _epi.packed_select(metric, topk, hi, lo)
    return out_ids, out_scores, n_cand.sum(0, dtype=torch.int32)


def merge_sample(metric: str, topk: int, mode: str, key, ids, scores,
                 n_cand, hits=None):
    """(S, B, k) per-slot draws -> the global draw: each drawn member's
    sampling key (``sample_key32`` of its noise and, for "weighted", its
    raw hit count ``hits``) recomputed, the first ``topk`` by (key,
    effective id) kept and presented as ``packed_select`` presents the
    top-k (K1's sampling order and fill); n_cand the union's size, the
    slots' sum (effective ids are unique across shards)."""
    from repro_torch.kernels.fused_query import noise_bits, sample_key32
    eff = _flat_slots(ids)
    score = _flat_slots(scores)
    valid = eff >= 0
    mult = (_flat_slots(hits) if hits is not None
            else torch.ones_like(eff, dtype=torch.int64))
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
    return out_ids, out_scores, n_cand.sum(0, dtype=torch.int32)


def drawn_hits(slot, keys: torch.Tensor, ids: torch.Tensor,
               chunk: int = 64) -> torch.Tensor:
    """The raw hit counts of a slot's drawn members: for (B, k) effective
    ``ids`` (-1 fill), how many of the slot's probed (table, probe)
    windows hold each, over its base block and slabs (``keys`` the (L, T,
    B) probe keys K1 expands, on the slot's device), ``chunk`` queries at
    a time -> (B, k) int64. The windows are those K1's plain version
    probes (``epilogues.probe_windows``), so the count is the one its
    weighted draw keyed the member by."""
    out = torch.zeros(ids.shape, dtype=torch.int64, device=ids.device)
    for seg, cap in zip(*_slot_pairs(slot)):
        for s in range(0, ids.shape[0], chunk):
            local, hit = _epi.probe_windows(seg.sorted_keys, seg.perm,
                                            keys[..., s:s + chunk], cap,
                                            seg.live, seg.win)
            eff = torch.where(hit, seg.eff[torch.where(hit, local, 0)
                                           .long()], -1)
            want = ids[s:s + chunk]
            out[s:s + chunk] += ((eff[:, None, :] == want[:, :, None])
                                 & (want[:, :, None] >= 0)).sum(-1)
    return out


def shard_map_candidates(family, view, mults, queries, *, probes: int = 1):
    """``segments.sharded_candidates`` over a mesh store's ``view``: the
    batch's K1 probe keys made once on the home device, each slot's
    candidate sets (``segments.segment_candidates`` over its pairs) on the
    slot's device, concatenated home in slot order -> (cand (B, W)
    effective ids with -1 fill, valid (B, W))."""
    keys = segments.k1_probe_keys(family, mults, queries, probes)
    home = keys.device
    parts = []
    for slot in view.slots:
        kd = keys.to(slot.device)
        cand, valid = segments._cat_candidates([
            segments.segment_candidates(seg, kd, cap)
            for seg, cap in zip(*_slot_pairs(slot))])
        parts.append((cand.to(home), valid.to(home)))
    return segments._cat_candidates(parts)
