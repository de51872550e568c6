"""Port parity: K1's multi-probe, live-window and multi-segment branches
(``fused_query_plain``) against the reference's Pallas ``fused_query``
(interpret mode), and the service's mutation endpoints.

On the ``tests/test_fused_probe.py`` device cell (``bucket_cap = 4``,
fresh and mutated, T in {1, 8}, the four kinds) the reference's store is
carried across with ``convert.store_from_numpy``, and both sides are given
the reference's raw projections:

* integer stages bitwise: per segment, the probe windows of the (L, T, B)
  keys (the live window here: every index has a ``bucket_cap``), the
  dedup'd candidate sets and counts;
* end to end: candidate counts bitwise, scores within
  ``parity.rerank_bound``, ids equal except at near ties;
* the service's ``insert`` / ``delete`` / ``prepare_compact`` /
  ``apply_swap`` / ``compact`` and their ``ServiceStats`` counters against
  the reference service's, and recall@k with ``probes`` within 0.05 of the
  reference's.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import DeviceLSHIndex as JaxIndex
from repro.core import projections as jproj
from repro.core import recall_at_k as jax_recall
from repro.core import segments as jseg
from repro.kernels import epilogues as jepi
from repro.kernels import fused_query as jfq
from repro.serving.lsh_service import build_service as jax_build_service
from repro_torch.core import recall_at_k as torch_recall
from repro_torch.core.index import DeviceLSHIndex
from repro_torch.kernels import epilogues as tepi
from repro_torch.kernels import parity
from repro_torch.kernels.fused_query import fused_query_plain
from repro_torch.serving.lsh_service import build_service

N, B, TOPK = 53, 6, 5
CELLS = [("cp-e2lsh", "euclidean"), ("cp-srp", "cosine"),
         ("tt-e2lsh", "euclidean"), ("tt-srp", "cosine")]


def _fmt(kind):
    tt = kind.startswith("tt-")
    return ((tb.tt_fixture, tb.jax_tt, tb.torch_tt) if tt
            else (tb.cp_fixture, tb.jax_cp, tb.torch_cp))


@pytest.fixture(scope="module", params=[
    (kind, metric, state) for kind, metric in CELLS
    for state in ("fresh", "mutated")], ids=lambda p: "-".join(p))
def case(request):
    kind, metric, state = request.param
    fixture, jwrap, twrap = _fmt(kind)
    corpus, queries = fixture(N, B, seed=12)
    fam = tb.jax_family(kind)
    idx = JaxIndex(fam, metric=metric, bucket_cap=4,
                   probe_backend="pallas").build(jwrap(corpus))
    if state == "mutated":           # test_fused_probe.py's _mutate
        idx.delete(jnp.arange(0, 12, 3))
        idx.insert(jwrap([f[:7] * (1.01 if i == 0 else 1.0)
                          for i, f in enumerate(corpus)]))
    store = tb.carry_store(idx.store)
    tfam = tb.bridge_family(fam)
    tidx = DeviceLSHIndex(tfam, metric=metric, bucket_cap=4)
    tidx.store = store
    return dict(kind=kind, metric=metric, state=state, fam=fam, idx=idx,
                tfam=tfam, tidx=tidx, jq=jwrap(queries), tq=twrap(queries),
                n_segs=len(store.view.segments))


@pytest.mark.parametrize("probes", [1, 8])
def test_probe_windows_and_dedup_bitwise(case, probes):
    """Per segment, on the reference's (L, T, B) keys: the live-window
    probe's ids and hits, the dedup'd candidates and validity."""
    view, tview = case["idx"].store.view, case["tidx"].store.view
    mults = jnp.asarray(case["idx"]._mults)
    keys = np.asarray(jseg.query_keys(case["fam"], mults, case["jq"],
                                      probes))
    if probes == 1:
        keys = keys[:, None]                       # the kernel's (L, 1, B)
    total = 0
    for i, cap in enumerate(view.all_caps):
        _, sk, perm, live, _, win = view.seg_arrays(i)
        assert win is not None
        ref_ids, ref_hit = jepi.probe_windows(sk, perm, jnp.asarray(keys),
                                              cap, live, win)
        ref_cand, ref_valid = jepi.dedup_windows(ref_ids, ref_hit,
                                                 sk.shape[1])
        t = tview.seg_arrays(i)
        ids, hit = tepi.probe_windows(t.sorted_keys, t.perm,
                                      torch.from_numpy(keys.astype(np.int64)),
                                      cap, t.live, t.win)
        cand, valid = tepi.dedup_windows(ids, hit, t.sorted_keys.shape[1])
        np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))
        np.testing.assert_array_equal(
            np.where(hit.numpy(), ids.numpy(), -1),
            np.where(np.asarray(ref_hit), np.asarray(ref_ids), -1))
        np.testing.assert_array_equal(cand.numpy(), np.asarray(ref_cand))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
        total += int(valid.sum())
    assert total > 0


@pytest.mark.parametrize("probes", [1, 8])
def test_fused_query_plain_vs_reference_kernel(case, probes):
    fam, idx = case["fam"], case["idx"]
    view = idx.store.view
    mults = idx._mults
    ref_ids, ref_sc, ref_nc = (np.array(a) for a in jfq.fused_query(
        fam, view.all_arrays, jnp.asarray(mults), case["jq"],
        metric=case["metric"], topk=TOPK, caps=view.all_caps, probes=probes,
        interpret=True))
    values = torch.from_numpy(np.array(jproj.project_batch(fam.projection,
                                                           case["jq"])))
    tfam = case["tfam"]
    tview = case["tidx"].store.view
    ids, sc, nc = fused_query_plain(
        values, tfam.offsets, torch.from_numpy(mults.astype(np.int64)),
        case["tq"].stack(), tview.all_arrays, kind=case["kind"],
        w=tfam.bucket_width, num_tables=tfam.num_tables,
        num_codes=tfam.num_codes, metric=case["metric"], topk=TOPK,
        caps=tview.all_caps, probes=probes)
    np.testing.assert_array_equal(nc.numpy(), ref_nc)
    corpus = case["tidx"].effective_corpus()
    tol = parity.rerank_bound(case["metric"], case["tq"], corpus,
                              torch.from_numpy(ref_ids),
                              torch.from_numpy(ref_sc))
    keep = (ids.numpy() == ref_ids) & (ref_ids >= 0)
    assert (np.abs(sc.numpy()[keep] - ref_sc[keep])
            <= tol.numpy()[keep]).all()
    assert parity.topk_mismatches(ids, sc, torch.from_numpy(ref_ids),
                                  torch.from_numpy(ref_sc), tol) == 0
    assert (ref_ids >= 0).any()
    assert case["n_segs"] == (2 if case["state"] == "mutated" else 1)


@pytest.fixture(scope="module", params=["cp-e2lsh", "tt-srp"])
def services(request):
    kind = request.param
    metric = "cosine" if kind.endswith("srp") else "euclidean"
    fixture, jwrap, twrap = _fmt(kind)
    k, w = tb.grid_params(kind)
    corpus, queries = fixture(61, 9, seed=21)
    ins, _ = fixture(14, 1, seed=121, clusters=3)
    jsvc = jax_build_service(tb.jax_key(42), kind, tb.DIMS, jwrap(corpus),
                             metric=metric, num_codes=k,
                             num_tables=tb.NUM_TABLES, rank=2,
                             bucket_width=w, bucket_cap=6, max_deltas=2,
                             probes=4, hash_backend="pallas",
                             probe_backend="pallas")
    fam = tb.bridge_family(jsvc.index.family)
    tsvc = build_service(None, kind, tb.DIMS, twrap(corpus), metric=metric,
                         num_codes=k, num_tables=tb.NUM_TABLES, device="cpu",
                         family=fam, bucket_cap=6, max_deltas=2, probes=4)
    return dict(kind=kind, jsvc=jsvc, tsvc=tsvc, jwrap=jwrap, twrap=twrap,
                queries=queries, ins=ins)


def test_service_mutation_endpoints_and_stats(services):
    s = services
    steps = [("insert", [a[:8] for a in s["ins"]]), ("delete", [0, 5, 60]),
             ("insert", [a[8:11] for a in s["ins"]]), ("delete", [2]),
             ("insert", [a[11:] for a in s["ins"]]),   # 3 > 2: auto-compact
             ("delete", [1, 3]), ("prepare_apply", None),
             ("insert", [a[:2] for a in s["ins"]]), ("compact", None),
             ("compact", None)]                         # pristine: no-op
    for op, arg in steps:
        for svc, wrap in ((s["jsvc"], s["jwrap"]), (s["tsvc"], s["twrap"])):
            if op == "insert":
                svc.insert(wrap(arg))
            elif op == "delete":
                assert svc.delete(np.asarray(arg)) == len(arg)
            elif op == "prepare_apply":
                pending = svc.prepare_compact()
                assert pending is not None
                svc.apply_swap(pending)
            else:
                svc.compact()
        assert s["tsvc"].index.size == s["jsvc"].index.size
        assert (len(s["tsvc"].index.store.deltas)
                == len(s["jsvc"].index.store.deltas))
    fields = ("inserted", "insert_batches", "deleted", "delete_batches",
              "compactions", "auto_compactions")
    jst, tst = s["jsvc"].stats, s["tsvc"].stats
    assert ({f: getattr(tst, f) for f in fields}
            == {f: getattr(jst, f) for f in fields})
    assert tst.auto_compactions == 1 and tst.compactions == 2
    assert tst.insert_ms > 0 and tst.auto_compact_ms > 0
    assert tst.compact_ms > 0 and tst.insert_items_per_s > 0
    with pytest.raises(TypeError, match="sharded index only"):
        s["tsvc"].rebalance()           # the reference's refusal
    with pytest.raises(TypeError, match="sharded index only"):
        s["jsvc"].rebalance()
    # every query still answers from the live corpus
    ids, _, n_cand = s["tsvc"].query_arrays(s["twrap"](s["queries"]),
                                            topk=TOPK)
    assert ((ids >= -1) & (ids < s["tsvc"].index.size)).all()
    assert (n_cand > 0).any()


def test_recall_with_probes_matches_reference(services):
    s = services
    s["jsvc"].insert(s["jwrap"]([a[:5] for a in s["ins"]]))
    s["tsvc"].insert(s["twrap"]([a[:5] for a in s["ins"]]))
    s["jsvc"].delete(np.arange(0, 20, 4))
    s["tsvc"].delete(np.arange(0, 20, 4))
    for probes in (1, 4):
        ref = jax_recall(s["jsvc"].index, s["jwrap"](s["queries"]),
                         topk=TOPK, probes=probes)
        got = torch_recall(s["tsvc"].index, s["twrap"](s["queries"]),
                           topk=TOPK, probes=probes)
        assert abs(got["recall"] - ref["recall"]) <= 0.05
        assert got["corpus_size"] == ref["corpus_size"]
        assert got["recall"] > 0
