"""Port parity: the TT query side (K1's TT re-rank in its plain version, the
TT segments and the TT service) against the reference.

Integer stages are held bitwise on the reference's own intermediates: given
the reference index's keys over a TT corpus, the port's sorted tables, cap,
probe windows and candidate sets equal the reference's; given its segment
arrays (carried over with ``convert.segment_from_numpy``) and its raw
projections, ``fused_query_plain`` gives the candidate counts of the
reference's Pallas ``fused_query`` (interpret mode). Float stages are held
to ``parity.rerank_bound``'s TT case (the chain's rounding bound carried
through the score expression): re-rank scores, the TT ``hoisted_scores``.
End to end, ``build_service(device="cpu")`` over a TT corpus against the
reference's, boundary-aware, with recall@k within 0.05, for both TT kinds
and both metrics.
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
from repro_torch import convert
from repro_torch.core import recall_at_k as torch_recall
from repro_torch.core import segments as tseg
from repro_torch.kernels import epilogues as tepi
from repro_torch.kernels import parity
from repro_torch.kernels.fused_query import fused_query_plain, window_plan
from repro_torch.kernels.ops import stack_tt
from repro_torch.serving.lsh_service import build_service

N, B, TOPK = 61, 9, 5
CELLS = [("tt-e2lsh", "euclidean"), ("tt-srp", "cosine"),
         ("tt-e2lsh", "cosine"), ("tt-srp", "euclidean")]


@pytest.fixture(scope="module", params=CELLS, ids=lambda p: "-".join(p))
def case(request):
    kind, metric = request.param
    fam = tb.jax_family(kind)
    corpus, queries = tb.tt_fixture(N, B, seed=11)
    idx = JaxIndex(fam, metric=metric, probe_backend="pallas").build(
        tb.jax_tt(corpus))
    view = idx.store.view
    arrays = view.all_arrays[0]
    seg = convert.segment_from_numpy(
        corpus, np.asarray(arrays[1]), np.asarray(arrays[2]),
        np.asarray(view.base.keys), view.all_caps[0], "cpu")
    return dict(kind=kind, metric=metric, fam=fam, idx=idx, view=view,
                corpus=corpus, queries=queries,
                tview=tseg.SegmentStore(seg).view,
                tfam=tb.bridge_family(fam))


def test_segment_from_numpy_holds_the_tt_corpus_once(case):
    seg = case["tview"].base
    assert seg.stacked.shape == (N, 3, 2, 4, 2)
    for view, c in zip(seg.corpus.cores, case["corpus"]):
        np.testing.assert_array_equal(view.numpy(), c)
        assert view.untyped_storage().data_ptr() == \
            seg.stacked.untyped_storage().data_ptr()


def test_tt_sorted_tables_bitwise(case):
    base = case["view"].base
    keys = torch.from_numpy(np.asarray(base.keys).astype(np.int64))
    seg = tseg.build_segment(keys, tb.torch_tt(case["corpus"]))
    np.testing.assert_array_equal(seg.sorted_keys.numpy(),
                                  np.asarray(base.sorted_keys))
    np.testing.assert_array_equal(seg.perm.numpy(), np.asarray(base.perm))
    assert seg.cap == base.cap


def _ref_keys(case):
    mults = jnp.asarray(case["idx"]._mults)
    return np.asarray(jseg.query_keys(case["fam"], mults,
                                      tb.jax_tt(case["queries"])))


def test_tt_query_keys_and_windows_bitwise(case):
    """T = 1 query keys equal the reference's outside boundary tables;
    given the reference's keys, the probe windows, candidate sets and
    counts are equal bit for bit."""
    ref = _ref_keys(case)                                  # (L, B)
    got = tseg.query_keys(case["tfam"], case["idx"]._mults,
                          tb.torch_tt(case["queries"])).numpy()
    near = tb.near_tables(case["tfam"], case["queries"]).T
    assert ((got == ref.astype(np.int64)) | near).all()
    _, sk, perm, live, _, _ = case["view"].all_arrays[0]
    cap = case["view"].all_caps[0]
    ref_ids, ref_hit = jepi.probe_windows(sk, perm, jnp.asarray(ref), cap,
                                          live)
    ref_cand, ref_valid = jepi.dedup_windows(ref_ids, ref_hit, sk.shape[1])
    t = case["tview"].seg_arrays(0)
    ids, hit = tepi.probe_windows(t.sorted_keys, t.perm,
                                  torch.from_numpy(ref.astype(np.int64)),
                                  cap, t.live)
    cand, valid = tepi.dedup_windows(ids, hit, t.sorted_keys.shape[1])
    np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(ref_cand))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert valid.sum() > 0


def test_tt_hoisted_scores_match_reference(case):
    """The TT re-rank (<Y, Y> per item, <Q, Q> per query, <Q, Y> per pair by
    the chain) against the reference's on the same candidate matrix."""
    rng = np.random.default_rng(6)
    safe = rng.integers(0, N, size=(B, 13))
    ref = np.asarray(jseg.hoisted_scores(
        case["metric"], tb.jax_tt(case["queries"]), tb.jax_tt(case["corpus"]),
        jnp.asarray(safe)))
    tq = tb.torch_tt(case["queries"])
    corpus = case["tview"].base.corpus
    got = tseg.hoisted_scores(case["metric"], tq, corpus,
                              torch.from_numpy(safe))
    tol = parity.rerank_bound(case["metric"], tq, corpus,
                              torch.from_numpy(safe), torch.from_numpy(ref))
    assert (np.abs(got.numpy() - ref) <= tol.numpy()).all()


def test_fused_query_plain_tt_vs_reference_kernel(case):
    fam, view, idx = case["fam"], case["view"], case["idx"]
    jq = tb.jax_tt(case["queries"])
    mults = idx._mults
    ref_ids, ref_sc, ref_nc = (np.array(a) for a in jfq.fused_query(
        fam, view.all_arrays, jnp.asarray(mults), jq, metric=case["metric"],
        topk=TOPK, caps=view.all_caps, interpret=True))
    values = torch.from_numpy(np.array(jproj.project_batch(fam.projection,
                                                           jq)))
    tfam = case["tfam"]
    offsets = (tfam.offsets if tfam.offsets is not None
               else torch.zeros(values.shape[1]))
    tq, tq_stacked = stack_tt(tb.torch_tt(case["queries"]))
    seg = case["tview"].seg_arrays(0)
    ids, sc, nc = fused_query_plain(
        values, offsets, torch.from_numpy(mults.astype(np.int64)),
        (tq, tq_stacked), (seg,), kind=case["kind"], w=tfam.bucket_width,
        num_tables=tfam.num_tables, num_codes=tfam.num_codes,
        metric=case["metric"], topk=TOPK, caps=view.all_caps)
    np.testing.assert_array_equal(nc.numpy(), ref_nc)
    tol = parity.rerank_bound(case["metric"], tq, seg.corpus,
                              torch.from_numpy(ref_ids),
                              torch.from_numpy(ref_sc))
    keep = (ids.numpy() == ref_ids) & (ref_ids >= 0)
    assert (np.abs(sc.numpy()[keep] - ref_sc[keep])
            <= tol.numpy()[keep]).all()
    assert parity.topk_mismatches(ids, sc, torch.from_numpy(ref_ids),
                                  torch.from_numpy(ref_sc), tol) == 0
    assert (ref_ids >= 0).any()


@pytest.fixture(scope="module", params=CELLS, ids=lambda p: "-".join(p))
def services(request):
    kind, metric = request.param
    k, w = tb.grid_params(kind)
    corpus, queries = tb.tt_fixture(67, 11, seed=21)
    jsvc = jax_build_service(tb.jax_key(42), kind, tb.DIMS,
                             tb.jax_tt(corpus), metric=metric, num_codes=k,
                             num_tables=tb.NUM_TABLES, rank=2,
                             bucket_width=w, hash_backend="pallas",
                             probe_backend="pallas")
    fam = tb.bridge_family(jsvc.index.family)
    tsvc = build_service(None, kind, tb.DIMS, tb.torch_tt(corpus),
                         metric=metric, num_codes=k,
                         num_tables=tb.NUM_TABLES, device="cpu", family=fam)
    return dict(kind=kind, metric=metric, jsvc=jsvc, tsvc=tsvc,
                corpus=corpus, queries=queries)


def test_tt_service_matches_reference(services):
    """Build keys equal outside boundary tables (sorted tables bitwise where
    a table's keys all agree); where a query's keys agree, its candidate
    count is equal, its scores within the bound and its ids equal except at
    near ties; recall@k within 0.05 of the reference's."""
    s = services
    jbase = s["jsvc"].index.store.base
    tbase = s["tsvc"].index.store.base
    ref_keys = np.asarray(jbase.keys).astype(np.int64)
    keys = tbase.keys.numpy()
    tfam = s["tsvc"].index.family
    assert ((keys == ref_keys) | tb.near_tables(tfam, s["corpus"])).all()
    same_tables = (keys == ref_keys).all(axis=0)
    np.testing.assert_array_equal(
        tbase.sorted_keys.numpy()[same_tables],
        np.asarray(jbase.sorted_keys).astype(np.int64)[same_tables])

    jq, tq = tb.jax_tt(s["queries"]), tb.torch_tt(s["queries"])
    ji, js, jn = s["jsvc"].query_arrays(jq, topk=TOPK)
    ti, ts, tn = s["tsvc"].query_arrays(tq, topk=TOPK)
    assert ti.shape == (11, TOPK) and ts.dtype == np.float32
    rows = ~tb.near_tables(tfam, s["queries"]).any(axis=1)
    if not tb.near_tables(tfam, s["corpus"]).any():
        np.testing.assert_array_equal(tn[rows], jn[rows])
    rows &= tn == jn
    assert rows.sum() >= 11 // 2
    tol = parity.rerank_bound(s["metric"], tq,
                              s["tsvc"].index.effective_corpus(),
                              torch.from_numpy(ji), torch.from_numpy(js))
    tol = tol.numpy()
    same = (ti == ji) & (ji >= 0) & rows[:, None]
    assert (np.abs(ts - js)[same] <= tol[same]).all()
    assert parity.topk_mismatches(
        torch.from_numpy(ti[rows]), torch.from_numpy(ts[rows]),
        torch.from_numpy(ji[rows]), torch.from_numpy(js[rows]),
        torch.from_numpy(tol[rows])) == 0

    ref = jax_recall(s["jsvc"].index, jq, topk=TOPK)
    got = torch_recall(s["tsvc"].index, tq, topk=TOPK)
    assert abs(got["recall"] - ref["recall"]) <= 0.05
    assert got["recall"] > 0 and got["corpus_size"] == 67


def test_sampled_tt_family_serves_on_cpu():
    """The port's own TT sampler end to end: every self-query returns
    itself first, for both TT kinds."""
    corpus, _ = tb.tt_fixture(40, 1, seed=5)
    gen = torch.Generator().manual_seed(3)
    for kind in tb.TT_KINDS:
        svc = build_service(gen, kind, tb.DIMS, tb.torch_tt(corpus),
                            num_codes=4, num_tables=3, rank=2,
                            bucket_width=2.0, device="cpu")
        ids, _, n_cand = svc.query_arrays(tb.torch_tt(corpus), topk=1)
        np.testing.assert_array_equal(ids[:, 0], np.arange(40))
        assert (n_cand >= 1).all()


def test_k1_tt_window_limit_is_stated():
    """With 4 KiB TT rows (the TT cell: dims (16,) * 4, R = 4) and two row
    buffers a warp, three K1 blocks fit an SM beside a 256-slot shared
    window: L * cap <= 256 at L = 10 never needs the global scratch, a
    larger one does ([tt-main]'s cap 440), and a smaller one gets a window
    of pow2(L * cap)."""
    assert window_plan(10, 25, 4, 16, 4, 4, tt=True) == (256, False)
    assert window_plan(10, 26, 4, 16, 4, 4, tt=True) == (256, True)
    assert window_plan(10, 440, 4, 16, 4, 4, tt=True) == (256, True)
    assert window_plan(10, 12, 4, 16, 4, 4, tt=True) == (128, False)
