"""Port parity: the mutable store (``SegmentStore``: delta segments,
tombstones, effective ids, live windows, compaction) against the
reference's, and the mutation contract of ``DeviceLSHIndex``.

* The reference's mutation script (``tests/test_index_mutation.py``: two
  inserts, ``DEL1`` / ``DEL2``) on CP and TT corpora: replayed on the
  port's store over the reference's own keys, every segment's sorted keys,
  permutation, cap, ``live``, ``eff``, ``live_rank``, ``live_pos`` and
  ``slot_pos`` are bitwise the reference's, and so is the compacted base.
* Mutated equals a fresh rebuild over the effective corpus: ids and
  candidate counts bitwise, scores within ``parity.rerank_bound`` while
  deltas are outstanding (other segment shapes, another summation order)
  and bitwise after ``compact()``.
* A delete-heavy capped index answers as a fresh capped build.
* The contract: auto-compaction past ``max_deltas``, compact on a pristine
  store is a no-op, on an empty store raises, out-of-range deletes raise, a
  stale ``apply_swap`` raises; ``host_state`` / ``restore`` round-trips;
  a reference store carried across by ``convert`` answers like the
  reference.
* The R1 twin: a deleted item never surfaces; the self-distance before the
  delete is held to the f32 cancellation bound (``parity.rerank_bound``),
  not to 1e-3 (ROADMAP.md, R1).
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import DeviceLSHIndex as JaxIndex
from repro_torch.core import segments as tseg
from repro_torch.core.index import DeviceLSHIndex
from repro_torch.core.lsh import make_family
from repro_torch.kernels import parity

N_CORPUS, N_QUERIES, TOPK = 48, 5, 5
N_INS1, N_INS2 = 12, 9
DEL1 = np.array([3, 40, 50, 59])   # valid in [0, 60): base + first delta
DEL2 = np.array([0, 33, 64])       # valid in [0, 65): post-DEL1 numbering
CELLS = [("cp-e2lsh", "euclidean"), ("cp-srp", "cosine"),
         ("tt-e2lsh", "euclidean"), ("tt-srp", "cosine")]


def _fmt(kind):
    tt = kind.startswith("tt-")
    return ((tb.tt_fixture, tb.jax_tt, tb.torch_tt) if tt
            else (tb.cp_fixture, tb.jax_cp, tb.torch_cp))


def _data(kind, seed=0):
    fixture, _, _ = _fmt(kind)
    corpus, queries = fixture(N_CORPUS, N_QUERIES, seed=seed)
    ins, _ = fixture(N_INS1 + N_INS2, 1, seed=seed + 100, clusters=3)
    return (corpus, queries, [a[:N_INS1] for a in ins],
            [a[N_INS1:] for a in ins])


def _cat(*parts):
    return [np.concatenate(ls) for ls in zip(*parts)]


def _drop(parts, ids):
    return [np.delete(a, ids, axis=0) for a in parts]


def _mutate(idx, corpus, ins1, ins2, wrap):
    """The fixed insert / delete interleaving -> the effective corpus
    (numpy leaves) a fresh rebuild must match."""
    idx.insert(wrap(ins1))
    eff = _cat(corpus, ins1)
    idx.delete(DEL1)
    eff = _drop(eff, DEL1)
    idx.insert(wrap(ins2))
    eff = _cat(eff, ins2)
    idx.delete(DEL2)
    return _drop(eff, DEL2)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _assert_segments_equal(tstore, jstore):
    tview, jview = tstore.view, jstore.view
    assert tview.all_caps == jview.all_caps
    for i in range(len(jview.segments)):
        t, j = tview.seg_arrays(i), jview.seg_arrays(i)
        np.testing.assert_array_equal(t.sorted_keys.numpy(),
                                      np.asarray(j[1]).astype(np.int64))
        np.testing.assert_array_equal(t.perm.numpy(), np.asarray(j[2]))
        np.testing.assert_array_equal(t.live.numpy(), np.asarray(j[3]))
        np.testing.assert_array_equal(t.eff.numpy(), np.asarray(j[4]))
        assert (t.win is None) == (j[5] is None)
        if j[5] is not None:
            for a, b in zip(t.win, j[5]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    th, jh = tstore.host_state(), jstore.host_state()
    for a, b in zip(th["slot_pos"], jh["slot_pos"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(th["live_host"], jh["live_host"])
    assert (th["seq_len"], th["live_window"]) == (jh["seq_len"],
                                                  jh["live_window"])
    assert (tstore.n_live, tstore.n_dead) == (jstore.n_live, jstore.n_dead)


@pytest.mark.parametrize("cap", [None, 4], ids=["exact", "cap4"])
@pytest.mark.parametrize("kind,metric", CELLS, ids=lambda p: str(p))
def test_mutation_script_lookups_bitwise(kind, metric, cap):
    """The reference's script, replayed on the port's store over the
    reference's keys: every lookup bitwise, then the compacted base."""
    _, jwrap, twrap = _fmt(kind)
    corpus, _, ins1, ins2 = _data(kind)
    fam = tb.jax_family(kind)
    jidx = JaxIndex(fam, metric=metric, bucket_cap=cap).build(jwrap(corpus))
    _mutate(jidx, corpus, ins1, ins2, jwrap)
    jsegs = [jidx.store.base] + list(jidx.store.deltas)
    segs = [tseg.build_segment(_t(s.keys), twrap(c), bucket_cap=cap)
            for s, c in zip(jsegs, (corpus, ins1, ins2))]
    store = tseg.SegmentStore(segs[0], live_window=cap is not None)
    store.append_delta(segs[1])
    store.delete_effective(DEL1)
    store.append_delta(segs[2])
    store.delete_effective(DEL2)
    _assert_segments_equal(store, jidx.store)
    assert store.generation == 5 and store.mutated

    tidx = DeviceLSHIndex(tb.bridge_family(fam), metric=metric,
                          bucket_cap=cap)
    tidx.store = store
    eff_t = tidx.effective_corpus()
    for a, b in zip(eff_t.leaves, tb.leaves_of(jidx.effective_corpus())):
        np.testing.assert_array_equal(a.numpy(), b)
    tidx.compact()
    jidx.compact()
    np.testing.assert_array_equal(tidx.store.base.keys.numpy(),
                                  np.asarray(jidx.store.base.keys))
    _assert_segments_equal(tidx.store, jidx.store)
    assert tidx.compactions == 1 and not tidx.store.mutated


@pytest.mark.parametrize("kind,metric", CELLS, ids=lambda p: str(p))
def test_mutated_equals_fresh_rebuild(kind, metric):
    _, _, twrap = _fmt(kind)
    corpus, queries, ins1, ins2 = _data(kind, seed=1)
    tfam = tb.bridge_family(tb.jax_family(kind))
    idx = DeviceLSHIndex(tfam, metric=metric).build(twrap(corpus))
    eff = _mutate(idx, corpus, ins1, ins2, twrap)
    assert idx.size == eff[0].shape[0] and len(idx.store.deltas) == 2
    for a, b in zip(idx.effective_corpus().leaves, eff):
        np.testing.assert_array_equal(a.numpy(), b)
    fresh = DeviceLSHIndex(tfam, metric=metric).build(twrap(eff))
    tq = twrap(queries)
    for probes in (1, 4):
        ids, sc, nc = idx.query_batch(tq, TOPK, probes=probes)
        wi, ws, wn = fresh.query_batch(tq, TOPK, probes=probes)
        np.testing.assert_array_equal(ids.numpy(), wi.numpy())
        np.testing.assert_array_equal(nc.numpy(), wn.numpy())
        tol = parity.rerank_bound(metric, tq, fresh.effective_corpus(), wi,
                                  ws)
        valid = wi >= 0
        assert torch.equal(sc[~valid], ws[~valid])
        assert bool(((sc - ws).abs() <= tol)[valid].all())
        assert (nc > 0).any()
    idx.compact()
    assert not idx.store.mutated and not idx.store.deltas
    for probes in (1, 4):
        got = idx.query_batch(tq, TOPK, probes=probes)
        want = fresh.query_batch(tq, TOPK, probes=probes)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w_.numpy())


@pytest.mark.parametrize("kind", ["cp-srp", "tt-srp"])
def test_capped_delete_heavy_equals_fresh_capped_rebuild(kind):
    """1-bit keys make huge buckets; after 20 of 48 items die, a cap-3
    index answers exactly as a fresh cap-3 build over the live corpus
    (the live window skips tombstones) and no probe comes back empty."""
    _, _, twrap = _fmt(kind)
    corpus, queries, _, _ = _data(kind, seed=5)
    fam = make_family(torch.Generator().manual_seed(11), kind, tb.DIMS,
                      num_codes=1, num_tables=2, rank=2, device="cpu")
    idx = DeviceLSHIndex(fam, metric="cosine", bucket_cap=3).build(
        twrap(corpus))
    dead = np.arange(0, 40, 2)
    idx.delete(dead)
    fresh = DeviceLSHIndex(fam, metric="cosine", bucket_cap=3).build(
        twrap(_drop(corpus, dead)))
    tq = twrap(queries)
    for probes in (1, 2):
        got = idx.query_batch(tq, TOPK, probes=probes)
        want = fresh.query_batch(tq, TOPK, probes=probes)
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w_.numpy())
        assert bool((got[2] > 0).all())
    assert idx.store.view.wins[0] is not None


def test_default_cap_keeps_no_window_lookups():
    corpus, _, _, _ = _data("cp-e2lsh", seed=6)
    idx = DeviceLSHIndex(tb.bridge_family(tb.jax_family("cp-e2lsh")),
                         metric="euclidean").build(tb.torch_cp(corpus))
    assert idx.store.view.wins == (None,)
    idx.delete([1])
    assert idx.store.view.wins == (None,)


def test_insert_past_max_deltas_auto_compacts():
    corpus, queries, ins1, ins2 = _data("cp-e2lsh", seed=5)
    tfam = tb.bridge_family(tb.jax_family("cp-e2lsh"))
    idx = DeviceLSHIndex(tfam, metric="euclidean", max_deltas=1).build(
        tb.torch_cp(corpus))
    idx.insert(tb.torch_cp(ins1))
    assert len(idx.store.deltas) == 1 and idx.compactions == 0
    idx.insert(tb.torch_cp(ins2))            # 2 > max_deltas -> compact
    assert len(idx.store.deltas) == 0 and idx.compactions == 1
    assert idx.auto_compactions == 1 and idx.auto_compact_s > 0
    fresh = DeviceLSHIndex(tfam, metric="euclidean").build(
        tb.torch_cp(_cat(corpus, ins1, ins2)))
    tq = tb.torch_cp(queries)
    for g, w_ in zip(idx.query_batch(tq, TOPK), fresh.query_batch(tq, TOPK)):
        np.testing.assert_array_equal(g.numpy(), w_.numpy())


def test_compaction_and_delete_contract():
    corpus, _, ins1, _ = _data("cp-srp", seed=7)
    tfam = tb.bridge_family(tb.jax_family("cp-srp"))
    idx = DeviceLSHIndex(tfam, metric="cosine").build(tb.torch_cp(corpus))
    store = idx.store
    idx.compact()                            # pristine: no-op
    assert idx.store is store and idx.compactions == 0
    assert idx.prepare_compact() is None
    with pytest.raises(IndexError):
        idx.delete([N_CORPUS])
    with pytest.raises(IndexError):
        idx.delete([-1])
    assert idx.delete([0, 0, 1]) == 2        # duplicates collapse
    assert idx.size == N_CORPUS - 2
    pending = idx.prepare_compact()
    idx.insert(tb.torch_cp(ins1))            # the live store moves on
    with pytest.raises(RuntimeError, match="stale"):
        idx.apply_swap(pending)
    idx.apply_swap(idx.prepare_compact())
    assert idx.size == N_CORPUS - 2 + N_INS1 and idx.compactions == 1
    idx.delete(np.arange(idx.size))
    assert idx.size == 0
    with pytest.raises(ValueError):
        idx.compact()


@pytest.mark.parametrize("kind,metric", CELLS[:3:2], ids=lambda p: str(p))
def test_host_state_restore_roundtrip(kind, metric):
    _, _, twrap = _fmt(kind)
    corpus, queries, ins1, ins2 = _data(kind, seed=8)
    idx = DeviceLSHIndex(tb.bridge_family(tb.jax_family(kind)),
                         metric=metric, bucket_cap=4).build(twrap(corpus))
    _mutate(idx, corpus, ins1, ins2, twrap)
    store = idx.store
    back = tseg.SegmentStore.restore([store.base] + store.deltas,
                                     store.host_state())
    for i in range(3):
        a, b = back.view.seg_arrays(i), store.view.seg_arrays(i)
        for x, y in zip((a.live, a.eff) + a.win, (b.live, b.eff) + b.win):
            assert torch.equal(x, y)
    tq = twrap(queries)
    want = idx.query_batch(tq, TOPK, probes=2)
    idx.store = back
    for g, w_ in zip(idx.query_batch(tq, TOPK, probes=2), want):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("kind,metric", CELLS, ids=lambda p: str(p))
def test_reference_store_carried_across(kind, metric):
    """A mutated reference store, carried by ``convert.store_from_numpy``:
    its lookups and effective corpus are the reference's, and queries
    through it answer like the reference's index (candidate counts equal on
    queries without a boundary code, ids equal except at near ties)."""
    _, jwrap, twrap = _fmt(kind)
    corpus, queries, ins1, ins2 = _data(kind, seed=9)
    fam = tb.jax_family(kind)
    jidx = JaxIndex(fam, metric=metric, bucket_cap=4,
                    probe_backend="pallas").build(jwrap(corpus))
    _mutate(jidx, corpus, ins1, ins2, jwrap)
    store = tb.carry_store(jidx.store)
    _assert_segments_equal(store, jidx.store)
    tfam = tb.bridge_family(fam)
    tidx = DeviceLSHIndex(tfam, metric=metric, bucket_cap=4)
    tidx.store = store
    for a, b in zip(tidx.effective_corpus().leaves,
                    tb.leaves_of(jidx.effective_corpus())):
        np.testing.assert_array_equal(a.numpy(), b)
    tq = twrap(queries)
    ji, js, jn = (np.asarray(a) for a in jidx.query_batch(
        jwrap(queries), topk=TOPK, probes=2))
    ti, ts, tn = tidx.query_batch(tq, TOPK, probes=2)
    clean = ~tb.near_tables(tfam, queries).any(axis=1)
    np.testing.assert_array_equal(tn.numpy()[clean], jn[clean])
    rows = torch.from_numpy(clean & (tn.numpy() == jn))
    tol = parity.rerank_bound(metric, tq, tidx.effective_corpus(),
                              torch.from_numpy(ji), torch.from_numpy(js))
    assert parity.topk_mismatches(ti[rows], ts[rows],
                                  torch.from_numpy(ji)[rows],
                                  torch.from_numpy(js)[rows],
                                  tol[rows]) == 0


def test_deleted_item_never_surfaces():
    """The R1 twin: an exact-member query finds its item first, at a
    distance within the f32 cancellation bound of
    sqrt(max(qq + yy - 2 qy, 0)); once the item is deleted it never comes
    back, even with the whole corpus as topk, and the returned ids index the
    live corpus."""
    corpus, _, _, _ = _data("cp-e2lsh", seed=2)
    tfam = tb.bridge_family(tb.jax_family("cp-e2lsh"))
    idx = DeviceLSHIndex(tfam, metric="euclidean").build(tb.torch_cp(corpus))
    q = tb.torch_cp([f[11:12] for f in corpus])
    ids, scores, _ = idx.query_batch(q, topk=1)
    tol = parity.rerank_bound("euclidean", q, idx.effective_corpus(), ids,
                              torch.zeros_like(scores))
    assert int(ids[0, 0]) == 11 and float(scores[0, 0]) <= float(tol[0, 0])
    idx.delete([11])
    ids, scores, n_cand = idx.query_batch(q, topk=N_CORPUS)
    assert int(n_cand[0]) <= N_CORPUS - 1
    live_orig = np.delete(np.arange(N_CORPUS), 11)
    got = ids[0][ids[0] >= 0].numpy()
    assert 11 not in live_orig[got]
    eff = idx.effective_corpus()
    want = parity.rerank_bound("euclidean", q, eff, ids, scores)
    from repro_torch.core.index import _score_matrix
    exact = _score_matrix("euclidean", q, eff)[0, got]
    assert bool(((scores[0, :got.size] - exact).abs()
                 <= want[0, :got.size] + 1e-6).all())
