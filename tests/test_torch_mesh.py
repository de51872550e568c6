"""Port parity: the mesh-sharded index (``repro_torch.distributed``), on
the CPU.

A mesh here is S slots of ``torch.device("cpu")`` laid out by the port's
``axis_rules``, so every slot's blocks, its per-slot K1s (the plain
version ``fused_query_sharded_plain``, once a slot) and the S-way merge
really run. The one-device baseline is the same ``ShardedLSHIndex`` built
under a rule context whose ``lsh_shard`` rule fits no axis (the
reference's fallback to its single program).

* Bit-equality with the one-device path (the reference's
  ``tests/test_index_sharded.py:215-241``): every kind and both metrics,
  at S in {1, 2, 4}, batches of 1 and 4, the exact cap and a
  ``bucket_cap``, T in {1, 4}: ids, scores and candidate counts, the
  sampling modes under one seed and ``candidates_batch``.
* The mutation sequence of ``tests/test_index_mutation.py:640-671``:
  routed slabs on the slots, deletes, ``compact``, auto-compaction past
  ``max_deltas``, ``rebalance`` (= a fresh mesh build), each step bit for
  bit against the one-device index.
* Against the reference in-process: its one-device ``ShardedLSHIndex``
  over the same family and corpus, within the parity contract.
* ``resolve_mesh`` / ``axis_rules`` / ``slot_devices`` / ``query_path``.
* Durability and serving: a mesh service's snapshot arrays are the
  one-device service's byte for byte, ``recover()`` onto a mesh answers
  bit for bit, and the scheduler serves a mesh service.

Corpus sizes are coprime to S (67: a padded last shard). The reference
hashes through XLA: no Pallas compilation (R3).
"""

import json
import os

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import grids
import torch_bridge as tb
from repro.core import ShardedLSHIndex as JaxSharded
from repro.core.lsh import ALL_KINDS
from repro_torch.core import segments
from repro_torch.core.index import DeviceLSHIndex, ShardedLSHIndex
from repro_torch.core.projections import project_batch
from repro_torch.core.tensor_formats import as_batch
from repro_torch.distributed import index_sharding
from repro_torch.distributed.sharding import Mesh, axis_rules, current
from repro_torch.kernels import parity
from repro_torch.kernels.fused_query import fused_query_sharded_plain
from repro_torch.serving.durability import DurableLSHService
from repro_torch.serving.lsh_service import LSHService
from repro_torch.serving.scheduler import ServingScheduler

CPU = torch.device("cpu")
N_CORPUS = 67          # coprime to every S: a padded last shard
TOPK = 5
CAP = 3                # the explicit bucket_cap cells


def _mesh(shards: int, axis: str = "shard") -> Mesh:
    return Mesh([CPU] * shards, (axis,))


def _no_mesh():
    """A rule context whose ``lsh_shard`` rule fits no mesh axis: the
    index keeps its one-device layout."""
    return axis_rules(Mesh([CPU], ("model",)))


@pytest.fixture(scope="module")
def data():
    corpus, queries = grids.corpus_and_queries(N_CORPUS, 4)
    ins, _ = grids.corpus_and_queries(12, 1, seed=5)
    return (torch.from_numpy(np.array(corpus)),
            torch.from_numpy(np.array(queries)),
            torch.from_numpy(np.array(ins)))


def _family(kind):
    return tb.bridge_family(grids.grid_family(kind, hash_backend="xla"))


def _pair(fam, metric, shards, corpus, **kw):
    """(mesh index, one-device index) over ``corpus``."""
    with axis_rules(_mesh(shards)):
        mesh = ShardedLSHIndex(fam, metric=metric, shards=shards,
                               **kw).build(corpus)
    with _no_mesh():
        one = ShardedLSHIndex(fam, metric=metric, shards=shards,
                              **kw).build(corpus)
    assert (mesh.query_path, one.query_path) == ("shard_map", "vmap")
    assert mesh.store.base.devices == (CPU,) * shards
    return mesh, one


def _same(got, want, what):
    for name, a, b in zip(("ids", "scores", "n_cand"), got, want):
        assert a.dtype == b.dtype, (what, name)
        assert torch.equal(a, b), (what, name)


def _assert_bit_equal(mesh, one, queries, probes=(1, 4), batches=(1, 4),
                      what=""):
    """ids / scores / counts, both sampling modes under one seed and the
    candidate sets of ``mesh`` and ``one``, bit for bit."""
    for b in batches:
        q = queries[:b]
        for t in probes:
            tag = (what, b, t)
            _same(mesh.query_batch(q, TOPK, probes=t),
                  one.query_batch(q, TOPK, probes=t), tag)
            for mode in ("uniform", "weighted"):
                _same(mesh.query_batch(q, TOPK, probes=t, mode=mode,
                                       rng=torch.Generator().manual_seed(7)),
                      one.query_batch(q, TOPK, probes=t, mode=mode,
                                      rng=torch.Generator().manual_seed(7)),
                      tag + (mode,))
            for a, b_ in zip(mesh.candidates_batch(q, probes=t),
                             one.candidates_batch(q, probes=t)):
                assert torch.equal(a, b_), tag + ("candidates",)


@pytest.mark.parametrize("shards", grids.SHARD_COUNTS)
@pytest.mark.parametrize("metric", grids.METRICS)
@pytest.mark.parametrize("kind", ALL_KINDS)
def test_mesh_equals_one_device(data, kind, metric, shards):
    corpus, queries, _ = data
    fam = _family(kind)
    for cap in (None, CAP):
        mesh, one = _pair(fam, metric, shards, corpus, bucket_cap=cap)
        calls = fused_query_sharded_plain.calls
        mesh.query_batch(queries, TOPK)
        assert fused_query_sharded_plain.calls == calls + shards
        _assert_bit_equal(mesh, one, queries, what=(kind, metric, cap))
        if cap is None:       # exact caps: the device index's ids, counts
            single = DeviceLSHIndex(fam, metric=metric).build(corpus)
            got, want = mesh.query_batch(queries, TOPK), \
                single.query_batch(queries, TOPK)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("cap", [None, CAP], ids=["exact", "cap"])
@pytest.mark.parametrize("shards", grids.SHARD_COUNTS)
@pytest.mark.parametrize("kind,metric", [("cp-e2lsh", "euclidean"),
                                         ("tt-srp", "cosine")])
def test_mutation_sequence(data, kind, metric, shards, cap):
    """Routed slabs, deletes, compaction, auto-compaction and rebalance on
    the mesh, every step bit for bit against the one-device index."""
    corpus, queries, ins = data
    fam = _family(kind)
    mesh, one = _pair(fam, metric, shards, corpus, bucket_cap=cap,
                      max_deltas=2)
    for idx in (mesh, one):
        idx.insert(ins[:5])
        idx.delete([3, 11, 40])
        idx.insert(ins[5:9])
        idx.delete([0, 60, 70])
    for seg in mesh.store.deltas:      # slabs live on the slots too
        assert seg.devices == (CPU,) * shards and seg.keys is None
    _assert_bit_equal(mesh, one, queries, batches=(4,), what="uncompacted")
    for a, b in zip(mesh.store.effective_arrays_chunked(7),
                    one.store.effective_arrays_chunked(7)):
        for x, y in zip(*(t.leaves if hasattr(t, "leaves") else (t,)
                          for t in (a, b))):
            assert torch.equal(x, y)
    for idx in (mesh, one):
        idx.compact()
    assert mesh.store.base.devices == (CPU,) * shards
    _assert_bit_equal(mesh, one, queries, batches=(4,), what="compacted")
    for idx in (mesh, one):            # past max_deltas: auto-compaction
        for lo in (9, 10, 11):
            idx.insert(ins[lo:lo + 1])
    assert mesh.auto_compactions == one.auto_compactions == 1
    _assert_bit_equal(mesh, one, queries, probes=(2,), batches=(4,),
                      what="auto-compacted")
    for idx in (mesh, one):
        idx.delete([1, 2])
        idx.rebalance()
    assert mesh.query_path == "shard_map" and mesh.store.base.blocks
    _assert_bit_equal(mesh, one, queries, probes=(2,), batches=(4,),
                      what="rebalanced")
    with axis_rules(_mesh(shards)):
        fresh = ShardedLSHIndex(fam, metric=metric, shards=shards,
                                bucket_cap=cap).build(mesh.effective_corpus())
    _assert_bit_equal(mesh, fresh, queries, probes=(1,), batches=(4,),
                      what="rebalance = fresh build")
    for a, b in zip(mesh.effective_corpus().leaves,
                    one.effective_corpus().leaves):
        assert torch.equal(a, b)
    assert mesh.corpus_sharded.leaves[0].shape[:2] == (
        shards, mesh.shard_size)


def _near_rows(tfam, queries) -> np.ndarray:
    """(B,) bool: queries with a code within the raw rounding bound of a
    bucket edge (E2LSH) or of 0 (SRP), where the two hashes may differ."""
    queries = as_batch(queries, len(tfam.projection.dims))
    l, k = tfam.num_tables, tfam.num_codes
    values = project_batch(tfam.projection, queries)
    bound = parity.family_raw_bound(tfam, queries)
    offs = None if tfam.offsets is None else tfam.offsets.reshape(l, k)
    b = values.shape[0]
    return parity.boundary_codes(values.reshape(b, l, k),
                                 bound.reshape(b, l, k), tfam.kind, offs,
                                 tfam.bucket_width).any(-1).any(-1).numpy()


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("kind,metric", [("cp-e2lsh", "euclidean"),
                                         ("tt-srp", "cosine"),
                                         ("e2lsh", "euclidean")])
def test_mesh_against_the_reference(data, kind, metric, shards):
    """The reference's one-device ``ShardedLSHIndex`` over the same family
    and corpus, after an insert and deletes: stored keys equal, counts
    equal outside near rows, ids equal except at near ties, scores within
    ``parity.rerank_bound``."""
    corpus, queries, ins = data
    jfam = grids.grid_family(kind, hash_backend="xla")
    ref = JaxSharded(jfam, metric=metric, shards=shards).build(
        corpus.numpy())
    with axis_rules(_mesh(shards)):
        mesh = ShardedLSHIndex(tb.bridge_family(jfam), metric=metric,
                               shards=shards).build(corpus)
    ref.insert(ins[:6].numpy())
    mesh.insert(ins[:6])
    ref.delete(np.array([2, 30, 70]))
    mesh.delete(np.array([2, 30, 70]))
    for a, b in zip([mesh.store.base] + mesh.store.deltas,
                    [ref.store.base] + ref.store.deltas):
        np.testing.assert_array_equal(
            torch.cat([blk.keys for blk in a.blocks]).numpy(),
            np.asarray(b.keys).astype(np.int64))
    ids, sc, nc = mesh.query_batch(queries, TOPK)
    ri, rs, rn = (np.array(a) for a in ref.query_batch(queries.numpy(),
                                                       TOPK))
    clean = ~_near_rows(mesh.family, queries)
    assert clean.any()
    np.testing.assert_array_equal(nc.numpy()[clean], rn[clean])
    tol = parity.rerank_bound(metric, as_batch(queries, 3),
                              mesh.effective_corpus(),
                              torch.from_numpy(ri), torch.from_numpy(rs))
    rows = torch.from_numpy(clean)
    assert parity.topk_mismatches(ids[rows], sc[rows],
                                  torch.from_numpy(ri)[rows],
                                  torch.from_numpy(rs)[rows],
                                  tol[rows]) == 0


def test_resolve_mesh_and_the_rule_context():
    # the CPU counts as one device: one slot at S = 1, none past it
    mesh, axis = index_sharding.resolve_mesh(1, "cpu")
    assert axis == "shard" and mesh.shape == {"shard": 1}
    assert index_sharding.slot_devices(mesh, axis) == [CPU]
    assert index_sharding.resolve_mesh(2, "cpu") == (None, None)
    assert index_sharding.resolve_mesh(2, "cuda") == (None, None) or (
        torch.cuda.device_count() >= 2)
    with axis_rules(_mesh(4)):
        assert current().rules["lsh_shard"] == ("shard",)
        mesh, axis = index_sharding.resolve_mesh(4, "cpu")
        assert (axis, mesh.size) == ("shard", 4)
        # the rule's axis has 4 slots: no mesh for 3 shards
        assert index_sharding.resolve_mesh(3, "cpu") == (None, None)
    assert current() is None
    # a 2-D mesh: the rule drops "shard" and keeps "data"; a slot is the
    # first device of its slice
    cards = [[torch.device("cuda", 0), torch.device("cuda", 1)],
             [torch.device("cuda", 2), torch.device("cuda", 3)]]
    grid = Mesh(cards, ("data", "model"))
    assert grid.shape == {"data": 2, "model": 2}
    assert index_sharding.slot_devices(grid, "data") == [
        torch.device("cuda", 0), torch.device("cuda", 2)]
    assert index_sharding.slot_devices(grid, "model") == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    with axis_rules(grid):
        assert current().rules["lsh_shard"] == ("data",)
        assert index_sharding.resolve_mesh(2, "cuda") == (grid, "data")
    with pytest.raises(ValueError, match="axis names"):
        Mesh([CPU, CPU], ("a", "b"))


def test_2d_mesh_places_the_index_on_the_data_axis(data):
    """The reference's ``test_rule_context_places_index_on_data_axis``: a
    (data = 2, model = 2) mesh puts the index on "data", and it answers as
    the one-device index."""
    corpus, queries, _ = data
    fam = _family("cp-e2lsh")
    with axis_rules(Mesh([[CPU, CPU], [CPU, CPU]], ("data", "model"))):
        idx = ShardedLSHIndex(fam, shards=2).build(corpus)
        assert idx.mesh_axis == "data" and idx.query_path == "shard_map"
    assert len(idx.store.base.blocks) == 2
    one = ShardedLSHIndex(fam, shards=2).build(corpus)   # no mesh on CPU
    assert one.query_path == "vmap" and one.mesh is None
    _same(idx.query_batch(queries[:3], TOPK),
          one.query_batch(queries[:3], TOPK), "data axis")


def test_refusals(data):
    corpus, _, _ = data
    fam = _family("cp-e2lsh")
    cards = Mesh([torch.device("cuda", 0)] * 2, ("shard",))
    with axis_rules(cards), pytest.raises(ValueError, match="mesh slot"):
        ShardedLSHIndex(fam, shards=2).build(corpus)
    seg = ShardedLSHIndex(fam, shards=1).build(corpus).store.base
    with pytest.raises(ValueError, match="already placed"):
        index_sharding.place_sharded(seg, _mesh(1), "shard")
    with _no_mesh():
        seg = ShardedLSHIndex(fam, shards=2).build(corpus).store.base
    with pytest.raises(ValueError, match="slots"):
        index_sharding.place_sharded(seg, _mesh(3), "shard")
    placed = index_sharding.place_shadow(seg, _mesh(2), "shard")
    back = segments.gather_blocks(placed)
    for name in ("keys", "sorted_keys", "perm", "stacked"):
        assert torch.equal(getattr(back, name), getattr(seg, name))
        assert all(getattr(b, name).data_ptr() != getattr(seg, name)
                   .data_ptr() for b in placed.blocks)


def _durable(directory, shards, mesh, corpus=None):
    """A durable service built over ``corpus``, or recovered from
    ``directory`` without one, on a mesh of S slots or on one device."""
    with axis_rules(_mesh(shards)) if mesh else _no_mesh():
        svc = DurableLSHService(_family("cp-e2lsh"), str(directory),
                                shards=shards, bucket_cap=16, max_deltas=2,
                                snapshot_every=10 ** 9)
        return svc.recover() if corpus is None else svc.build(corpus)


@pytest.mark.parametrize("shards", [2, 4])
def test_mesh_snapshots_and_recovery(tmp_path, data, shards):
    """A mesh service's snapshot arrays equal the one-device service's byte
    for byte (each sharded array's blocks gathered in shard order);
    ``recover()`` onto a new mesh, and a one-device directory onto a mesh,
    answer bit for bit as the live service."""
    corpus, queries, ins = data
    dirs = {m: tmp_path / ("mesh" if m else "one") for m in (True, False)}
    live = {}
    for m, d in dirs.items():
        svc = _durable(d, shards, m, corpus)
        svc.insert(ins[:5])
        svc.delete(np.array([1, 8, 50]))
        svc.insert(ins[5:8])
        svc.compact()
        svc.insert(ins[8:11])
        svc.delete(np.array([0, 66]))
        svc.snapshot()
        svc.close()
        live[m] = svc
    assert live[True].index.query_path == "shard_map"
    _same(tuple(map(torch.from_numpy, live[True].query_arrays(queries,
                                                              TOPK))),
          tuple(map(torch.from_numpy, live[False].query_arrays(queries,
                                                               TOPK))),
          "live")
    snaps = {m: sorted(n for n in os.listdir(d) if n.startswith("snap_"))[-1]
             for m, d in dirs.items()}
    manifests = {m: json.load(open(dirs[m] / snaps[m] / "manifest.json"))
                 for m in dirs}
    assert manifests[True] == manifests[False]
    for name in sorted(os.listdir(dirs[True] / snaps[True])):
        with open(dirs[True] / snaps[True] / name, "rb") as a, \
                open(dirs[False] / snaps[False] / name, "rb") as b:
            assert a.read() == b.read(), name
    for m in (True, False):          # each directory onto a new mesh
        rec = _durable(dirs[m], shards, True)
        assert rec.index.query_path == "shard_map"
        assert rec.index.store.base.devices == (CPU,) * shards
        _same(tuple(map(torch.from_numpy, rec.query_arrays(queries, TOPK))),
              tuple(map(torch.from_numpy, live[True].query_arrays(queries,
                                                                  TOPK))),
              ("recovered", m))
        rec.insert(ins[:2])          # and it keeps mutating on the mesh
        assert rec.index.store.deltas[-1].devices == (CPU,) * shards
        rec.close()


def test_scheduler_serves_a_mesh_service(data):
    corpus, queries, ins = data
    with axis_rules(_mesh(2)):
        svc = LSHService(_family("cp-e2lsh"), shards=2).build(corpus)
    direct = svc.query_arrays(queries, topk=TOPK)
    sched = ServingScheduler({"mesh": svc}, max_batch=4, deadline_ms=1.0)
    try:
        rows = [f.result(timeout=30) for f in
                [sched.query(queries[i], topk=TOPK, tenant="mesh")
                 for i in range(4)]]
        for i, (ids, scores, nc) in enumerate(rows):
            assert np.array_equal(ids, direct[0][i])
            assert np.array_equal(scores, direct[1][i])
            assert nc == direct[2][i]
        sched.insert(ins[:3], tenant="mesh").result(timeout=30)
        ids, _, _ = sched.query(queries[0], topk=TOPK,
                                tenant="mesh").result(timeout=30)
        assert np.array_equal(ids, svc.query_arrays(queries[:1],
                                                    topk=TOPK)[0][0])
        assert svc.index.store.deltas[-1].devices == (CPU, CPU)
    finally:
        sched.close()
    assert svc.index.query_path == "shard_map"
