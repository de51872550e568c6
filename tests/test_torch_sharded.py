"""Port parity: the sharded layout (``ShardedSegment``, routed delta slabs,
the shard-local fold, sharded live windows, ``SegmentStore`` over a
sharded base) against the reference's, bitwise on the reference's keys.

* ``build_sharded_segment`` at S in {1, 2, 3} over n = 50 (so the last
  shard is padded): keys, sorted keys, perm with the n_s pad sentinel,
  counts, exact and explicit cap, and the zero-padded corpus rows.
* ``route_balanced`` on seeded loads; ``build_sharded_delta``'s slab width
  (quantized to 8, then 64 past 256 slots) and positions map.
* The reference's mutation script (an insert, deletes, a second insert,
  deletes) on a sharded store, replayed on the port's store over the
  reference's own keys: every segment's arrays, ``live``, ``eff``,
  ``live_rank`` / ``live_pos`` (a ``bucket_cap`` store), ``slot_pos`` and
  ``shard_live_counts`` bitwise; then the shard-local ``compact()`` (the
  port's one-pass ``_slab_gather_sort`` against the reference's chunked
  fold: counts, ``base_pos``, cap) and ``rebalance()``.
* ``SegmentStore.restore`` of a carried sharded store (``convert``).
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import ShardedLSHIndex as JaxSharded
from repro.core import segments as jseg
from repro_torch.core import segments as tseg
from repro_torch.core.index import ShardedLSHIndex

N_CORPUS, N_INS1, N_INS2 = 50, 13, 9
DEL1 = np.array([2, 17, 40, 55])   # valid in [0, 63): base + first slab
DEL2 = np.array([0, 30, 61, 66])   # valid in [0, 68): post-DEL1 numbering


def _fmt(kind):
    tt = kind.startswith("tt-")
    return ((tb.tt_fixture, tb.jax_tt, tb.torch_tt) if tt
            else (tb.cp_fixture, tb.jax_cp, tb.torch_cp))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _keys(fam, mults, corpus):
    return np.asarray(jseg.bucket_keys(fam, jnp.asarray(mults), corpus, 64))


def _assert_segment_equal(t, j):
    np.testing.assert_array_equal(t.keys.numpy(),
                                  np.asarray(j.keys).astype(np.int64))
    np.testing.assert_array_equal(t.sorted_keys.numpy(),
                                  np.asarray(j.sorted_keys).astype(np.int64))
    np.testing.assert_array_equal(t.perm.numpy(), np.asarray(j.perm))
    assert (t.cap, t.counts) == (j.cap, j.counts)
    for a, b in zip(t.corpus.leaves, tb.leaves_of(j.corpus)):
        np.testing.assert_array_equal(a.numpy(), b)


def _assert_store_equal(tstore, jstore):
    tview, jview = tstore.view, jstore.view
    assert len(tview.segments) == len(jview.segments)
    for i, (t, j) in enumerate(zip(tview.segments, jview.segments)):
        _assert_segment_equal(t, j)
        ta, ja = tview.seg_arrays(i), jview.seg_arrays(i)
        np.testing.assert_array_equal(ta.live.numpy(), np.asarray(ja[3]))
        np.testing.assert_array_equal(ta.eff.numpy(), np.asarray(ja[4]))
        assert (ta.win is None) == (ja[5] is None)
        if ja[5] is not None:
            for a, b in zip(ta.win, ja[5]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    th, jh = tstore.host_state(), jstore.host_state()
    for a, b in zip(th["slot_pos"], jh["slot_pos"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(th["live_host"], jh["live_host"])
    assert (th["seq_len"], th["live_window"]) == (jh["seq_len"],
                                                  jh["live_window"])
    np.testing.assert_array_equal(tstore.shard_live_counts,
                                  jstore.shard_live_counts)
    assert (tstore.n_live, tstore.n_dead) == (jstore.n_live, jstore.n_dead)


@pytest.mark.parametrize("cap", [None, 5], ids=["exact", "cap5"])
@pytest.mark.parametrize("shards", [1, 2, 3])
@pytest.mark.parametrize("kind", ["cp-e2lsh", "tt-srp"])
def test_build_sharded_segment_bitwise(kind, shards, cap):
    fixture, jwrap, twrap = _fmt(kind)
    corpus, _ = fixture(N_CORPUS, 1, seed=shards)
    fam = tb.jax_family(kind)
    keys = _keys(fam, np.arange(1, fam.num_codes + 1, dtype=np.uint32) * 7,
                 jwrap(corpus))
    ref = jseg.build_sharded_segment(jnp.asarray(keys), jwrap(corpus),
                                     shards, bucket_cap=cap)
    got = tseg.build_sharded_segment(_t(keys), twrap(corpus), shards,
                                     bucket_cap=cap)
    _assert_segment_equal(got, ref)
    n_s = -(-N_CORPUS // shards)
    assert got.shard_size == n_s and got.items == N_CORPUS
    pads = got.perm == n_s
    assert int(pads.sum()) == (shards * n_s - N_CORPUS) * fam.num_tables
    assert got.stacked.shape[:2] == (shards, n_s)
    assert not got.stacked.flatten(0, 1)[N_CORPUS:].any()


def test_route_balanced_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(40):
        s = int(rng.integers(1, 6))
        loads = rng.integers(0, 50, size=s)
        batch = int(rng.integers(0, 120))
        for a, b in zip(tseg.route_balanced(batch, loads),
                        jseg.route_balanced(batch, loads)):
            np.testing.assert_array_equal(a, b)
    alloc, offsets = tseg.route_balanced(10, [5, 0, 3, 9])
    assert alloc.sum() == 10 and alloc[3] == 0 and offsets[1] == 0


@pytest.mark.parametrize("batch,loads", [(20, [4, 0, 9]), (700, [0, 0, 0]),
                                          (9, [100, 3])])
def test_build_sharded_delta_slab_and_positions(batch, loads):
    corpus, _ = tb.cp_fixture(batch, 1, seed=batch)
    fam = tb.jax_family("cp-e2lsh")
    keys = _keys(fam, np.arange(3, 3 + fam.num_codes, dtype=np.uint32),
                 tb.jax_cp(corpus))
    alloc, offsets = tseg.route_balanced(batch, loads)
    ref, ref_pos = jseg.build_sharded_delta(
        jnp.asarray(keys), tb.jax_cp(corpus), alloc, offsets, seq0=31)
    got, pos = tseg.build_sharded_delta(_t(keys), tb.torch_cp(corpus), alloc,
                                        offsets, seq0=31)
    _assert_segment_equal(got, ref)
    np.testing.assert_array_equal(pos, ref_pos)
    raw = int(alloc.max())
    assert got.shard_size % (64 if raw >= 256 else 8) == 0
    assert got.shard_size - raw < (64 if raw >= 256 else 8)


@pytest.fixture(scope="module", params=[
    ("cp-e2lsh", "euclidean", 3, None), ("cp-srp", "cosine", 2, 4),
    ("tt-e2lsh", "euclidean", 3, 4)], ids=lambda p: "-".join(map(str, p)))
def script(request):
    """The reference's sharded store after the mutation script, and the
    port's replay of it on the reference's keys (the port's own routing,
    which must place every item where the reference did)."""
    kind, metric, shards, cap = request.param
    fixture, jwrap, twrap = _fmt(kind)
    corpus, _ = fixture(N_CORPUS, 1, seed=4)
    ins, _ = fixture(N_INS1 + N_INS2, 1, seed=104, clusters=3)
    ins1, ins2 = [a[:N_INS1] for a in ins], [a[N_INS1:] for a in ins]
    fam = tb.jax_family(kind)
    jidx = JaxSharded(fam, metric=metric, shards=shards,
                      bucket_cap=cap).build(jwrap(corpus))
    mults = jidx._mults
    store = tseg.SegmentStore(
        tseg.build_sharded_segment(_t(_keys(fam, mults, jwrap(corpus))),
                                   twrap(corpus), shards, bucket_cap=cap),
        live_window=cap is not None)
    for batch, dead in ((ins1, DEL1), (ins2, DEL2)):
        jidx.insert(jwrap(batch))
        alloc, offsets = tseg.route_balanced(N_INS1 if batch is ins1
                                             else N_INS2,
                                             store.shard_live_counts)
        seg, pos = tseg.build_sharded_delta(
            _t(_keys(fam, mults, jwrap(batch))), twrap(batch), alloc,
            offsets, seq0=store.seq_len, bucket_cap=cap)
        store.append_delta(seg, pos)
        jidx.delete(dead)
        store.delete_effective(dead)
    tidx = ShardedLSHIndex(tb.bridge_family(fam), metric=metric,
                           shards=shards, bucket_cap=cap)
    tidx.store = store
    return dict(jidx=jidx, tidx=tidx, cap=cap, shards=shards)


def test_mutation_script_lookups_bitwise(script):
    jstore, tstore = script["jidx"].store, script["tidx"].store
    _assert_store_equal(tstore, jstore)
    assert len(tstore.deltas) == 2 and tstore.mutated
    assert all(isinstance(d, tseg.ShardedSegment) for d in tstore.deltas)
    occ = tstore.shard_live_counts
    assert occ.sum() == tstore.n_live
    assert (tstore.view.wins[0] is not None) == (script["cap"] is not None)
    for a, b in zip(script["tidx"].effective_corpus().leaves,
                    tb.leaves_of(script["jidx"].effective_corpus())):
        np.testing.assert_array_equal(a.numpy(), b)


def test_carried_sharded_store_restores(script):
    """A reference sharded store carried by ``convert.store_from_numpy``
    (``SegmentStore.restore``) derives the reference's lookups."""
    jstore = script["jidx"].store
    carried = tb.carry_store(jstore)
    _assert_store_equal(carried, jstore)
    assert isinstance(carried.base, tseg.ShardedSegment)


def test_shard_local_compact_then_rebalance_bitwise(script):
    """The shard-local fold against the reference's (chunked) fold:
    counts, ``base_pos`` (the compacted base's ``slot_pos``), cap, every
    array; shards keep their item mix. Then ``rebalance`` restores the
    contiguous layout of a fresh build."""
    jidx, tidx = script["jidx"], script["tidx"]
    occ = tidx.occupancy().copy()
    jidx.compact()
    tidx.compact()
    _assert_store_equal(tidx.store, jidx.store)
    assert not tidx.store.deltas and not tidx.store.mutated
    np.testing.assert_array_equal(tidx.occupancy(), occ)
    assert tidx.store.base.counts == tuple(int(c) for c in occ)
    assert tidx.compactions == 1 and tidx.corpus is not None
    jidx.rebalance()
    tidx.rebalance()
    _assert_store_equal(tidx.store, jidx.store)
    n_s = tidx.shard_size
    assert n_s == -(-tidx.size // script["shards"])
    assert tidx.rebalances == 1
    for a, b in zip(tidx.corpus.leaves, tb.leaves_of(jidx.corpus)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_sharded_live_window_tables_match_per_table_build():
    """The one-pass sharded live-window lookups equal the per-(shard,
    table) build of the single-device ``_live_window_tables``."""
    rng = np.random.default_rng(8)
    s, nt, n = 3, 4, 23
    perm = torch.stack([torch.stack([torch.from_numpy(rng.permutation(n + 1)
                                                      [:n])
                                     for _ in range(nt)]) for _ in range(s)])
    live = torch.from_numpy(rng.random((s, n + 1)) < 0.6)
    live[:, n] = False
    rank, pos = tseg._live_window_tables_sharded(perm.to(torch.int32), live)
    for sh in range(s):
        r, p = tseg._live_window_tables(perm[sh].to(torch.int32), live[sh])
        assert torch.equal(rank[sh], r) and torch.equal(pos[sh], p)
