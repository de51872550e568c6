"""Port parity, end to end: ``build_service(..., device="cpu")`` against the
reference's ``build_service`` (Pallas hash and probe backends, interpret
mode), with the reference's sampled family carried over.

* Build: the port's corpus-order keys equal the reference's except in
  tables holding a code within the raw rounding bound of a bucket edge
  (``parity.raw_bound``); where every key of a table is equal, its sorted
  keys and permutation are equal bit for bit, and so is the cap.
* Queries: where the query keys equal the reference's, candidate counts are
  equal, scores lie within ``parity.rerank_bound`` and ids are equal except
  at near ties.
* recall@k against brute force within 0.05 of the reference's (one id of
  the 20 per query set may move across a near tie or a boundary code).
* The service's request contract: validation errors as in the reference
  (``rebalance`` without shards raises its ``TypeError``), the sampling
  modes served, and the host mode (``device=False``) served on the
  family's device, rebuild-only.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import recall_at_k as jax_recall
from repro.serving.lsh_service import build_service as jax_build_service
from repro_torch.core import recall_at_k as torch_recall
from repro_torch.core.lsh import make_family
from repro_torch.kernels import parity
from repro_torch.serving.lsh_service import build_service

N, B, TOPK = 67, 11, 4


@pytest.fixture(scope="module", params=[("cp-e2lsh", "euclidean"),
                                        ("cp-srp", "cosine")],
                ids=lambda p: "-".join(p))
def services(request):
    kind, metric = request.param
    k, w = tb.grid_params(kind)
    corpus, queries = tb.cp_fixture(N, B, seed=21)
    jsvc = jax_build_service(tb.jax_key(42), kind, tb.DIMS,
                             tb.jax_cp(corpus), metric=metric, num_codes=k,
                             num_tables=tb.NUM_TABLES, rank=2,
                             bucket_width=w, hash_backend="pallas",
                             probe_backend="pallas")
    fam = tb.bridge_family(jsvc.index.family)
    tsvc = build_service(None, kind, tb.DIMS, tb.torch_cp(corpus),
                         metric=metric, num_codes=k,
                         num_tables=tb.NUM_TABLES, device="cpu", family=fam)
    return dict(kind=kind, metric=metric, jsvc=jsvc, tsvc=tsvc,
                corpus=corpus, queries=queries)


def _near_tables(s, factors):
    return tb.near_tables(s["tsvc"].index.family, factors)


def test_build_matches_reference(services):
    s = services
    jbase = s["jsvc"].index.store.base
    tbase = s["tsvc"].index.store.base
    ref_keys = np.asarray(jbase.keys).astype(np.int64)
    keys = tbase.keys.numpy()
    near = _near_tables(s, s["corpus"])
    assert ((keys == ref_keys) | near).all()
    same_tables = (keys == ref_keys).all(axis=0)
    assert same_tables.any()
    np.testing.assert_array_equal(
        tbase.sorted_keys.numpy()[same_tables],
        np.asarray(jbase.sorted_keys).astype(np.int64)[same_tables])
    np.testing.assert_array_equal(tbase.perm.numpy()[same_tables],
                                  np.asarray(jbase.perm)[same_tables])
    if same_tables.all():
        assert tbase.cap == jbase.cap
    assert s["tsvc"].stats.build_s > 0


def test_queries_match_reference(services):
    s = services
    ji, js, jn = s["jsvc"].query_arrays(tb.jax_cp(s["queries"]), topk=TOPK)
    ti, ts, tn = s["tsvc"].query_arrays(tb.torch_cp(s["queries"]), topk=TOPK)
    assert ti.shape == (B, TOPK) and ti.dtype == np.int32
    assert ts.dtype == np.float32 and tn.dtype == np.int32
    clean = ~_near_tables(s, s["queries"]).any(axis=1)
    if not _near_tables(s, s["corpus"]).any():
        np.testing.assert_array_equal(tn[clean], jn[clean])
    tq = tb.torch_cp(s["queries"])
    corpus = s["tsvc"].index.effective_corpus()
    tol = parity.rerank_bound(s["metric"], tq, corpus, torch.from_numpy(ji),
                              torch.from_numpy(js)).numpy()
    rows = clean & (tn == jn)
    assert rows.sum() >= B // 2
    same = (ti == ji) & (ji >= 0) & rows[:, None]
    assert (np.abs(ts - js)[same] <= tol[same]).all()
    assert parity.topk_mismatches(
        torch.from_numpy(ti[rows]), torch.from_numpy(ts[rows]),
        torch.from_numpy(ji[rows]), torch.from_numpy(js[rows]),
        torch.from_numpy(tol[rows])) == 0
    assert s["tsvc"].stats.queries == B and s["tsvc"].stats.batches == 1


def test_recall_matches_reference(services):
    s = services
    ref = jax_recall(s["jsvc"].index, tb.jax_cp(s["queries"]), topk=TOPK)
    got = torch_recall(s["tsvc"].index, tb.torch_cp(s["queries"]), topk=TOPK)
    assert abs(got["recall"] - ref["recall"]) <= 0.05
    assert got["corpus_size"] == ref["corpus_size"] == N
    assert got["recall"] > 0


def test_query_batch_dicts(services):
    out = services["tsvc"].query_batch(tb.torch_cp(services["queries"]),
                                       topk=TOPK)
    assert len(out) == B
    for row in out:
        assert (row["ids"] >= 0).all() and len(row["ids"]) <= TOPK
        assert row["candidates"] >= len(row["ids"])


def test_request_validation_and_queued_features(services):
    svc = services["tsvc"]
    q = tb.torch_cp(services["queries"])
    with pytest.raises(ValueError):
        svc.query_arrays(q, topk=0)
    with pytest.raises(ValueError):
        svc.query_arrays(q, probes=0)
    with pytest.raises(ValueError):
        svc.query_arrays(q, mode="nope")
    with pytest.raises(ValueError):
        svc.query_arrays(q, mode="uniform")          # no seed
    with pytest.raises(ValueError):
        svc.query_arrays(q, seed=3)                  # seed on topk
    ids, _, _ = svc.query_arrays(q, mode="weighted", seed=1)  # sampling:
    assert ids.shape == (B, 10)                                # served
    ids, _, _ = svc.query_arrays(q, probes=2)        # multi-probe: served
    assert ids.shape == (B, 10)
    for call in (svc.rebalance, svc.prepare_rebalance):
        with pytest.raises(TypeError, match="sharded index only"):
            call()                                   # as the reference's
    host = build_service(None, services["kind"], tb.DIMS, q, device=False,
                         num_codes=svc.index.family.num_codes,
                         num_tables=tb.NUM_TABLES, family=svc.index.family)
    assert type(host.index).__name__ == "HostLSHIndex"   # served
    ids, _, _ = host.query_arrays(q)
    assert ids.shape == (B, 10)
    with pytest.raises(TypeError, match="rebuild-only"):
        host.insert(q)


def test_sampled_family_serves_on_cpu():
    """The port's own sampler, end to end: a self-query returns itself."""
    corpus, _ = tb.cp_fixture(40, 1, seed=5)
    gen = torch.Generator().manual_seed(3)
    svc = build_service(gen, "cp-e2lsh", tb.DIMS, tb.torch_cp(corpus),
                        num_codes=4, num_tables=3, rank=2, bucket_width=2.0,
                        device="cpu")
    ids, scores, n_cand = svc.query_arrays(tb.torch_cp(corpus), topk=1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(40))
    assert (n_cand >= 1).all()
    # the naive kinds build and answer (over a dense corpus and over the
    # CP one, re-ranked in CP)
    dense = torch.from_numpy(np.random.default_rng(7).normal(
        size=(40,) + tb.DIMS).astype(np.float32))
    for kind, data in (("srp", dense), ("e2lsh", tb.torch_cp(corpus))):
        svc = build_service(gen, kind, tb.DIMS, data, num_codes=4,
                            num_tables=3, bucket_width=2.0, device="cpu")
        ids, _, n_cand = svc.query_arrays(data, topk=1)
        np.testing.assert_array_equal(ids[:, 0], np.arange(40))
        assert (n_cand >= 1).all()
    assert make_family(gen, "srp", tb.DIMS, device="cpu").storage_size() \
        == 8 * 64
