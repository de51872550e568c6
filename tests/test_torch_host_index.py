"""Port parity: the host-dict index, the single-query API and the
service's host mode (``device=False``), against the reference.

* ``HostLSHIndex.candidates`` (the port's dicts) against the reference's
  ``HostLSHIndex.candidates`` at T = 1 and T = 4 on a carried-over family,
  for every query whose codes lie away from the bucket edges
  (``torch_bridge.near_tables``), CP and TT; against the port's own
  ``candidates_batch`` and K1's ``n_candidates`` for every query, the pad
  regime (T past the expansion size) included.
* ``candidates_batch`` / ``candidates`` / ``query`` on ``DeviceLSHIndex``
  and ``ShardedLSHIndex`` after an insert and deletes: the candidate sets
  equal the reference's ``candidates_batch`` rows, each row's count is
  K1's, and ``query(x)`` / ``candidates(x)`` equal their batch rows.
* ``brute_force`` against the reference's (ids equal but at near ties,
  scores within ``parity.rerank_bound``) and its own batch row.
* ``build_service(..., device=False)`` against the reference's host-mode
  service (keys through XLA); mutations refused with its ``TypeError``,
  ``shards`` and ``bucket_cap`` with its ``ValueError``.

The reference hashes through XLA (``hash_backend="xla"``), so these tests
compile no Pallas kernel.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import DeviceLSHIndex as JaxDevice
from repro.core import HostLSHIndex as JaxHost
from repro.core import ShardedLSHIndex as JaxSharded
from repro.core import brute_force as jax_brute_force
from repro.serving.lsh_service import build_service as jax_build_service
from repro_torch.core import (DeviceLSHIndex, HostLSHIndex, ShardedLSHIndex,
                              brute_force, brute_force_batch)
from repro_torch.core.lsh import make_family
from repro_torch.kernels import parity
from repro_torch.serving.lsh_service import build_service

N, B = 61, 9
CASES = [("cp-e2lsh", "euclidean"), ("tt-srp", "cosine")]


def _data(kind, n=N, b=B, seed=4):
    """(numpy leaves of the corpus, of the queries) in the kind's format."""
    fixture = tb.tt_fixture if kind.startswith("tt-") else tb.cp_fixture
    return fixture(n, b, seed=seed)


def _wrap(kind, leaves):
    """(reference tensor, port tensor) of the same leaves."""
    if kind.startswith("tt-"):
        return tb.jax_tt(leaves), tb.torch_tt(leaves)
    return tb.jax_cp(leaves), tb.torch_cp(leaves)


def _item(x, i):
    return type(x)(tuple(a[i] for a in tb.leaves_of(x)), x.scale) \
        if not isinstance(x, torch.Tensor) and hasattr(x, "scale") else x[i]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: c[0])
def case(request):
    kind, metric = request.param
    fam = tb.jax_family(kind, backend="xla")
    tfam = tb.bridge_family(fam)
    corpus, queries = _data(kind)
    jc, tc = _wrap(kind, corpus)
    jq, tq = _wrap(kind, queries)
    clean = ~tb.near_tables(tfam, queries).any(axis=1)
    return dict(kind=kind, metric=metric, fam=fam, tfam=tfam, jc=jc, tc=tc,
                jq=jq, tq=tq, clean=clean, corpus=corpus)


def test_host_candidates_match_reference(case):
    c = case
    jhost = JaxHost(c["fam"], metric=c["metric"]).build(c["jc"])
    host = HostLSHIndex(c["tfam"], metric=c["metric"]).build(c["tc"])
    assert host.size == N and c["clean"].sum() >= B // 2
    dev = DeviceLSHIndex(c["tfam"], metric=c["metric"]).build(c["tc"])
    for probes in (1, 4):
        cand, valid = dev.candidates_batch(c["tq"], probes=probes)
        _, _, n_cand = host.query_batch(c["tq"], probes=probes)
        for i in range(B):
            got = host.candidates(c["tq"].index(i), probes=probes)
            assert got.dtype == np.int64 and (np.diff(got) > 0).all()
            want = np.sort(cand[i][valid[i]].numpy())
            np.testing.assert_array_equal(got, want)
            assert got.size == int(n_cand[i])
            if c["clean"][i]:
                ref = jhost.candidates(_item(c["jq"], i), probes=probes)
                assert set(got.tolist()) == set(np.asarray(ref).tolist())


def test_host_pad_regime_counts_each_member_once():
    """T - 1 past the expansion size (srp, K = 2: 3 candidates, T = 8): the
    pad slots repeat the base key; the dicts and K1 count a member once."""
    gen = torch.Generator().manual_seed(3)
    fam = make_family(gen, "srp", tb.DIMS, num_codes=2, num_tables=3,
                      device="cpu")
    x = torch.randn((40,) + tb.DIMS, generator=gen)
    host = HostLSHIndex(fam, metric="cosine").build(x)
    _, _, n_cand = host.query_batch(x[:7], probes=8)
    for i in range(7):
        one = host.candidates(x[i], probes=1)
        eight = host.candidates(x[i], probes=8)
        assert set(one.tolist()) <= set(eight.tolist())
        assert eight.size == int(n_cand[i]) == np.unique(eight).size


@pytest.mark.parametrize("shards", [None, 3])
def test_candidates_batch_and_single_queries_after_mutations(case, shards):
    c = case
    extra, _ = _data(c["kind"], n=11, b=1, seed=9)
    jx, tx = _wrap(c["kind"], extra)
    dels = [2, 9, 30, 44]
    if shards is None:
        jidx = JaxDevice(c["fam"], metric=c["metric"])
        idx = DeviceLSHIndex(c["tfam"], metric=c["metric"])
    else:
        jidx = JaxSharded(c["fam"], metric=c["metric"], shards=shards)
        idx = ShardedLSHIndex(c["tfam"], metric=c["metric"], shards=shards)
    jidx.build(c["jc"]).insert(jx)
    idx.build(c["tc"]).insert(tx)
    jidx.delete(np.array(dels))
    idx.delete(dels)
    near = tb.near_tables(c["tfam"], extra).any()
    for probes in (1, 4):
        cand, valid = idx.candidates_batch(c["tq"], probes=probes)
        assert cand.shape == valid.shape and cand.dtype == torch.int32
        assert bool((cand[~valid] == -1).all())
        jcand, jvalid = (np.asarray(a) for a in jidx.candidates_batch(
            c["jq"], probes=probes))
        ids_b, scores_b, n_cand = idx.query_batch(c["tq"], probes=probes)
        np.testing.assert_array_equal(valid.sum(1).numpy(), n_cand.numpy())
        for i in range(B):
            row = np.sort(cand[i][valid[i]].numpy())
            assert (row < idx.size).all()
            if c["clean"][i] and not near:
                assert set(row.tolist()) == set(jcand[i][jvalid[i]].tolist())
            x = c["tq"].index(i)
            np.testing.assert_array_equal(idx.candidates(x, probes=probes),
                                          row)
            ids, scores, nc = idx.query(x, probes=probes)
            keep = ids_b[i] >= 0
            np.testing.assert_array_equal(ids, ids_b[i][keep].numpy())
            np.testing.assert_array_equal(scores, scores_b[i][keep].numpy())
            assert nc == int(n_cand[i]) == row.size
            assert ids.dtype == np.int64 and (ids < idx.size).all()


def test_brute_force_matches_reference(case):
    c = case
    ids_b, scores_b = brute_force_batch(c["metric"], c["tq"], c["tc"], 5)
    for i in range(B):
        ids, scores = brute_force(c["metric"], c["tq"].index(i), c["tc"], 5)
        np.testing.assert_array_equal(ids, ids_b[i])
        np.testing.assert_array_equal(scores, scores_b[i])
        jids, jscores = jax_brute_force(c["metric"], _item(c["jq"], i),
                                        c["jc"], 5)
        tol = parity.rerank_bound(c["metric"], c["tq"].index(slice(i, i + 1)),
                                  c["tc"], torch.from_numpy(ids[None]),
                                  torch.from_numpy(scores[None]))
        assert parity.topk_mismatches(
            torch.from_numpy(ids[None]), torch.from_numpy(scores[None]),
            torch.from_numpy(np.asarray(jids)[None]),
            torch.from_numpy(np.asarray(jscores)[None]), tol) == 0
    # a dense corpus and query as plain tensors
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(30,) + tb.DIMS).astype(np.float32))
    ids, scores = brute_force("euclidean", x[3], x, 4)
    # the self-distance is the f32 cancellation of qq + yy - 2 qy (R1)
    assert ids[0] == 3 and scores[0] < 0.05 * scores[1]


def test_host_service_matches_reference(case):
    c = case
    k = c["tfam"].num_codes
    jsvc = jax_build_service(tb.jax_key(42), c["kind"], tb.DIMS, c["jc"],
                             metric=c["metric"], num_codes=k,
                             num_tables=tb.NUM_TABLES, rank=2,
                             bucket_width=c["tfam"].bucket_width,
                             device=False, hash_backend="xla")
    tfam = tb.bridge_family(jsvc.index.family)
    svc = build_service(None, c["kind"], tb.DIMS, c["tc"],
                        metric=c["metric"], num_codes=k,
                        num_tables=tb.NUM_TABLES, family=tfam, device=False)
    assert isinstance(svc.index, HostLSHIndex) and svc.device == tfam.device
    clean = ~tb.near_tables(tfam, _data(c["kind"])[1]).any(axis=1)
    ji, js, jn = jsvc.query_arrays(c["jq"], topk=4)
    ti, ts, tn = svc.query_arrays(c["tq"], topk=4)
    np.testing.assert_array_equal(tn[clean], jn[clean])
    tol = parity.rerank_bound(c["metric"], c["tq"], c["tc"],
                              torch.from_numpy(ji), torch.from_numpy(js))
    rows = torch.from_numpy(clean)
    assert parity.topk_mismatches(
        torch.from_numpy(ti)[rows], torch.from_numpy(ts)[rows],
        torch.from_numpy(ji)[rows], torch.from_numpy(js)[rows],
        tol[rows]) == 0
    assert svc.stats.queries == B and svc.stats.batches == 1
    out = svc.query_batch(c["tq"], topk=4, probes=2)
    assert len(out) == B and all(r["candidates"] >= len(r["ids"])
                                 for r in out)
    ids, _, _ = svc.query_arrays(c["tq"], mode="uniform", seed=3)
    assert ids.shape == (B, 10)
    # rebuild-only, as the reference refuses
    for call in (lambda: svc.insert(c["tq"]), lambda: svc.delete([1]),
                 svc.compact, svc.prepare_compact,
                 lambda: svc.apply_swap(None), svc.rebalance,
                 svc.prepare_rebalance):
        with pytest.raises(TypeError, match="rebuild-only"):
            call()
    for call in (lambda: jsvc.insert(c["jq"]), jsvc.compact):
        with pytest.raises(TypeError, match="rebuild-only"):
            call()
    with pytest.raises(ValueError, match="shards"):
        build_service(None, c["kind"], tb.DIMS, c["tc"], num_codes=k,
                      num_tables=tb.NUM_TABLES, family=tfam, device=False,
                      shards=2)
    with pytest.raises(ValueError, match="bucket_cap"):
        build_service(None, c["kind"], tb.DIMS, c["tc"], num_codes=k,
                      num_tables=tb.NUM_TABLES, family=tfam, device=False,
                      bucket_cap=4)
