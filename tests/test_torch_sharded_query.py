"""Port parity: K1s's plain version (``fused_query_sharded_plain``) against
the reference's Pallas ``fused_query_sharded`` (interpret mode) and its
``sharded_query_vmap_reference``, and the sharded index and service.

On a mutated S = 3 reference store (a deleted stride of the base, one
routed slab), CP and TT, exact and ``bucket_cap`` 4, carried across with
``convert.store_from_numpy``, both sides are given the reference's raw
projections: candidate counts bitwise, ids equal except at near ties,
scores within ``parity.rerank_bound``, at T in {1, 4} (the Pallas kernel
at T = 4 only, to keep its interpret-mode programs to a handful: ROADMAP.md
R3).

The port's own invariants: shard-count invariance against its
``DeviceLSHIndex`` (exact cap, fresh and mutated: ids and candidate counts
bitwise, scores within the bound, as the plain version's batched
contractions may round differently over other segment shapes; the card's
kernel scores each candidate alone and ``chip_smoke.py`` holds scores
bitwise there), ``rebalance()`` equal to a fresh sharded build bit for
bit, tombstones never surfacing, the ``LSHService(shards=S)`` endpoints
and their stats against the reference service's, and the refusals.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import ShardedLSHIndex as JaxSharded
from repro.core import projections as jproj
from repro.core import segments as jseg
from repro.kernels import fused_query as jfq
from repro.serving.lsh_service import build_service as jax_build_service
from repro_torch.core.index import DeviceLSHIndex, ShardedLSHIndex
from repro_torch.kernels import parity
from repro_torch.kernels.fused_query import (fused_query_sharded,
                                             fused_query_sharded_plain)
from repro_torch.serving.lsh_service import LSHService, build_service

N, B, TOPK, SHARDS = 53, 6, 5, 3
CELLS = [("cp-e2lsh", "euclidean"), ("tt-srp", "cosine")]


def _fmt(kind):
    tt = kind.startswith("tt-")
    return ((tb.tt_fixture, tb.jax_tt, tb.torch_tt) if tt
            else (tb.cp_fixture, tb.jax_cp, tb.torch_cp))


def _scaled(leaves):
    """test_fused_probe.py's insert: the first 7 items, mode 0 scaled."""
    return [f[:7] * (1.01 if i == 0 else 1.0) for i, f in enumerate(leaves)]


@pytest.fixture(scope="module", params=[
    (kind, metric, cap) for kind, metric in CELLS for cap in (None, 4)],
    ids=lambda p: "-".join(map(str, p)))
def case(request):
    kind, metric, cap = request.param
    fixture, jwrap, twrap = _fmt(kind)
    corpus, queries = fixture(N, B, seed=14)
    fam = tb.jax_family(kind)
    idx = JaxSharded(fam, metric=metric, shards=SHARDS, bucket_cap=cap,
                     probe_backend="pallas").build(jwrap(corpus))
    idx.delete(jnp.arange(0, 12, 3))
    idx.insert(jwrap(_scaled(corpus)))
    tfam = tb.bridge_family(fam)
    tidx = ShardedLSHIndex(tfam, metric=metric, shards=SHARDS,
                           bucket_cap=cap)
    tidx.store = tb.carry_store(idx.store)
    values = torch.from_numpy(np.array(jproj.project_batch(fam.projection,
                                                           jwrap(queries))))
    return dict(kind=kind, metric=metric, cap=cap, fam=fam, idx=idx,
                tfam=tfam, tidx=tidx, jq=jwrap(queries), tq=twrap(queries),
                values=values)


def _port_plain(case, probes):
    tfam, tview = case["tfam"], case["tidx"].store.view
    return fused_query_sharded_plain(
        case["values"], tfam.offsets,
        torch.from_numpy(case["idx"]._mults.astype(np.int64)),
        case["tq"].stack(), tview.seg_arrays(0), tview.delta_arrays,
        kind=case["kind"], w=tfam.bucket_width, num_tables=tfam.num_tables,
        num_codes=tfam.num_codes, metric=case["metric"], topk=TOPK,
        cap=tview.base.cap, delta_caps=tview.delta_caps, probes=probes)


def _assert_matches(case, got, ref):
    ids, sc, nc = got
    ref_ids, ref_sc, ref_nc = (np.array(a) for a in ref)
    np.testing.assert_array_equal(nc.numpy(), ref_nc)
    tol = parity.rerank_bound(case["metric"], case["tq"],
                              case["tidx"].effective_corpus(),
                              torch.from_numpy(ref_ids),
                              torch.from_numpy(ref_sc))
    keep = (ids.numpy() == ref_ids) & (ref_ids >= 0)
    assert (np.abs(sc.numpy()[keep] - ref_sc[keep])
            <= tol.numpy()[keep]).all()
    assert parity.topk_mismatches(ids, sc, torch.from_numpy(ref_ids),
                                  torch.from_numpy(ref_sc), tol) == 0
    assert (ref_ids >= 0).any() and (ref_nc > 0).all()


@pytest.mark.parametrize("probes", [1, 4])
def test_plain_vs_reference_vmap(case, probes):
    view = case["idx"].store.view
    ref = jseg.sharded_query_vmap_reference(
        case["fam"], view.seg_arrays(0), view.delta_arrays,
        jnp.asarray(case["idx"]._mults), case["jq"], metric=case["metric"],
        topk=TOPK, cap=view.base.cap, delta_caps=view.delta_caps,
        probes=probes)
    calls = fused_query_sharded_plain.calls
    _assert_matches(case, _port_plain(case, probes), ref)
    assert fused_query_sharded_plain.calls == calls + 1
    assert len(case["tidx"].store.view.k1_segments[0]) == SHARDS * 2


def test_plain_vs_reference_pallas_kernel(case):
    view = case["idx"].store.view
    ref = jfq.fused_query_sharded(
        case["fam"], view.seg_arrays(0), view.delta_arrays,
        jnp.asarray(case["idx"]._mults), case["jq"], metric=case["metric"],
        topk=TOPK, cap=view.base.cap, delta_caps=view.delta_caps, probes=4,
        interpret=True)
    _assert_matches(case, _port_plain(case, 4), ref)


def test_cpu_wrapper_runs_the_plain_version(case):
    """On CPU tensors K1s's wrapper is its plain version (one plain call,
    no launch), and the index's query goes through it."""
    tfam, tview = case["tfam"], case["tidx"].store.view
    launches = fused_query_sharded.launches
    calls = fused_query_sharded_plain.calls
    got = fused_query_sharded(
        case["values"], tfam.offsets,
        torch.from_numpy(case["idx"]._mults.astype(np.int64)),
        case["tq"].stack(), tview.seg_arrays(0), tview.delta_arrays,
        kind=case["kind"], w=tfam.bucket_width, num_tables=tfam.num_tables,
        num_codes=tfam.num_codes, metric=case["metric"], topk=TOPK,
        cap=tview.base.cap, delta_caps=tview.delta_caps, probes=2)
    want = _port_plain(case, 2)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert fused_query_sharded.launches == launches
    assert fused_query_sharded_plain.calls == calls + 2
    case["tidx"].query_batch(case["tq"], TOPK)
    assert fused_query_sharded_plain.calls == calls + 3


def _data(kind, seed):
    fixture, _, twrap = _fmt(kind)
    corpus, queries = fixture(61, 7, seed=seed)
    ins, _ = fixture(11, 1, seed=seed + 100, clusters=3)
    return corpus, queries, ins, twrap


@pytest.mark.parametrize("kind,metric", CELLS, ids=lambda p: str(p))
def test_shard_count_invariance(kind, metric):
    corpus, queries, ins, twrap = _data(kind, 3)
    tfam = tb.bridge_family(tb.jax_family(kind))
    tq = twrap(queries)
    for shards in (1, 2, 3):
        single = DeviceLSHIndex(tfam, metric=metric).build(twrap(corpus))
        sharded = ShardedLSHIndex(tfam, metric=metric,
                                  shards=shards).build(twrap(corpus))
        for state in ("fresh", "mutated"):
            if state == "mutated":
                for idx in (single, sharded):
                    idx.delete([0, 9, 40])
                    idx.insert(twrap(ins))
                    idx.delete([55, 60])
            for probes in (1, 3):
                ids, sc, nc = sharded.query_batch(tq, TOPK, probes=probes)
                wi, ws, wn = single.query_batch(tq, TOPK, probes=probes)
                np.testing.assert_array_equal(ids.numpy(), wi.numpy())
                np.testing.assert_array_equal(nc.numpy(), wn.numpy())
                tol = parity.rerank_bound(metric, tq,
                                          single.effective_corpus(), wi, ws)
                valid = wi >= 0
                assert bool(((sc - ws).abs() <= tol)[valid].all())
                assert torch.equal(sc[~valid], ws[~valid])


def test_more_shards_than_items():
    """n < S leaves whole shards as padding (counts 0): ids and counts
    still equal the single-device index's, and inserts route into the
    empty shards first."""
    corpus, queries, ins, twrap = _data("cp-e2lsh", 4)
    tfam = tb.bridge_family(tb.jax_family("cp-e2lsh"))
    tiny = twrap([a[:3] for a in corpus])
    sharded = ShardedLSHIndex(tfam, shards=4).build(tiny)
    assert sharded.store.base.counts == (1, 1, 1, 0)
    single = DeviceLSHIndex(tfam).build(tiny)
    tq = twrap(queries)
    for idx in (sharded, single):
        idx.insert(twrap([a[:2] for a in ins]))
    np.testing.assert_array_equal(sharded.occupancy(), [1, 1, 1, 2])
    got, want = sharded.query_batch(tq, TOPK), single.query_batch(tq, TOPK)
    for g, w_ in zip(got[::2], want[::2]):
        np.testing.assert_array_equal(g.numpy(), w_.numpy())


@pytest.mark.parametrize("cap", [None, 4], ids=["exact", "cap4"])
def test_rebalance_equals_fresh_build(cap):
    corpus, queries, ins, twrap = _data("tt-e2lsh", 5)
    tfam = tb.bridge_family(tb.jax_family("tt-e2lsh"))
    idx = ShardedLSHIndex(tfam, shards=3, bucket_cap=cap, max_deltas=8,
                          keep_corpus=False).build(twrap(corpus))
    assert idx.corpus is None           # keep_corpus=False while pristine
    idx.insert(twrap(ins))
    idx.delete(np.arange(0, 30, 4))
    idx.insert(twrap([a[:5] for a in ins]))
    idx.compact()
    assert (idx.compactions, idx.rebalances) == (1, 0)
    idx.delete([1, 2])
    idx.rebalance()
    assert (idx.compactions, idx.rebalances) == (1, 1)
    fresh = ShardedLSHIndex(tfam, shards=3, bucket_cap=cap).build(
        idx.effective_corpus())
    assert idx.store.base.counts == fresh.store.base.counts
    tq = twrap(queries)
    for probes in (1, 2):
        for g, w_ in zip(idx.query_batch(tq, TOPK, probes=probes),
                         fresh.query_batch(tq, TOPK, probes=probes)):
            assert torch.equal(g, w_)


def test_tombstones_never_surface():
    corpus, _, ins, twrap = _data("cp-e2lsh", 6)
    tfam = tb.bridge_family(tb.jax_family("cp-e2lsh"))
    idx = ShardedLSHIndex(tfam, shards=3, bucket_cap=3).build(twrap(corpus))
    idx.insert(twrap(ins))
    seq = np.arange(61 + 11)                 # effective id -> item
    dead = np.array([4, 11, 33, 60, 63, 70])
    idx.delete(dead)
    seq = np.delete(seq, dead)
    both = [np.concatenate(ls) for ls in zip(corpus, ins)]
    q = twrap([a[dead] for a in both])
    for probes in (1, 4):
        ids, _, nc = idx.query_batch(q, topk=idx.size, probes=probes)
        got = ids.numpy()
        assert not np.isin(seq[got[got >= 0]], dead).any()
        assert (nc.numpy() <= idx.size).all()
    idx.compact()
    ids, _, _ = idx.query_batch(q, topk=idx.size)
    assert not np.isin(seq[ids.numpy()[ids.numpy() >= 0]], dead).any()


def test_service_endpoints_and_stats_match_reference():
    kind, metric = "cp-e2lsh", "euclidean"
    corpus, queries, ins, twrap = _data(kind, 7)
    k, w = tb.grid_params(kind)
    jsvc = jax_build_service(tb.jax_key(42), kind, tb.DIMS,
                             tb.jax_cp(corpus), metric=metric, num_codes=k,
                             num_tables=tb.NUM_TABLES, rank=2,
                             bucket_width=w, shards=SHARDS, max_deltas=2,
                             bucket_cap=6)
    tsvc = build_service(None, kind, tb.DIMS, twrap(corpus), metric=metric,
                         num_codes=k, num_tables=tb.NUM_TABLES, device="cpu",
                         family=tb.bridge_family(jsvc.index.family),
                         shards=SHARDS, max_deltas=2, bucket_cap=6)
    assert isinstance(tsvc.index, ShardedLSHIndex)
    assert tsvc.stats.shard_occupancy == jsvc.stats.shard_occupancy
    steps = [("insert", [a[:8] for a in ins]), ("delete", [0, 5, 60]),
             ("insert", [a[8:] for a in ins]), ("delete", [2, 3, 4, 6]),
             ("insert", [a[:2] for a in ins]),        # 3 > 2: auto-compact
             ("delete", [1]), ("prepare_apply", None), ("compact", None),
             ("rebalance", None), ("insert", [a[2:9] for a in ins])]
    for op, arg in steps:
        for svc, wrap in ((jsvc, tb.jax_cp), (tsvc, twrap)):
            if op == "insert":
                svc.insert(wrap(arg))
            elif op == "delete":
                assert svc.delete(np.asarray(arg)) == len(arg)
            elif op == "prepare_apply":
                svc.apply_swap(svc.prepare_rebalance())
            else:
                getattr(svc, op)()
        assert tsvc.stats.shard_occupancy == jsvc.stats.shard_occupancy
        assert tsvc.index.size == jsvc.index.size
    fields = ("inserted", "insert_batches", "deleted", "delete_batches",
              "compactions", "auto_compactions", "rebalances")
    jst, tst = jsvc.stats, tsvc.stats
    assert ({f: getattr(tst, f) for f in fields}
            == {f: getattr(jst, f) for f in fields})
    assert tst.rebalances == 2 and tst.rebalance_ms > 0
    assert tst.occupancy_skew == pytest.approx(jst.occupancy_skew)
    assert 1.0 <= tst.occupancy_skew < 1.2
    ids, _, n_cand = tsvc.query_arrays(twrap(queries), topk=TOPK)
    assert ((ids >= -1) & (ids < tsvc.index.size)).all() and (n_cand > 0).all()
    tsvc.build(twrap(corpus))             # a rebuild resets the history
    assert tst.rebalances == 0 and tst.shard_occupancy == (21, 21, 19)


def test_refusals():
    corpus, _, _, twrap = _data("cp-srp", 8)
    tfam = tb.bridge_family(tb.jax_family("cp-srp"))
    for bad in (0, -2):
        with pytest.raises(ValueError, match="shards"):
            ShardedLSHIndex(tfam, metric="cosine", shards=bad)
        with pytest.raises(ValueError, match="shards"):
            LSHService(tfam, metric="cosine", shards=bad)
    svc = build_service(None, "cp-srp", tb.DIMS, twrap(corpus),
                        metric="cosine", num_codes=tfam.num_codes,
                        num_tables=tfam.num_tables, device="cpu",
                        family=tfam)
    for call in (svc.rebalance, svc.prepare_rebalance):
        with pytest.raises(TypeError, match="sharded"):
            call()
    with pytest.raises(ValueError, match="shards"):
        build_service(None, "cp-srp", tb.DIMS, twrap(corpus), device=False,
                      shards=2)
    idx = ShardedLSHIndex(tfam, metric="cosine", shards=2).build(
        twrap(corpus))
    idx.delete(np.arange(idx.size))
    with pytest.raises(ValueError, match="no live items"):
        idx.rebalance()
    with pytest.raises(ValueError, match="Generator"):
        idx.query_batch(twrap(corpus), mode="uniform")     # no rng
