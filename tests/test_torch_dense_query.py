"""Port parity: the query side on dense corpora (K1's and K1s's dense
re-rank in their plain versions, the dense segments, the service) against
the reference, on ``grids.corpus_and_queries``' dense fixture for the
naive kinds and the tensorized kinds over dense rows.

Integer stages are held bitwise on the reference's own intermediates: given
the reference index's keys over the dense corpus, the port's sorted tables,
perm and cap equal the reference's; given its store (carried over with
``torch_bridge.carry_store``, dense rows and all) and its raw projections,
``fused_query_plain`` / ``fused_query_sharded_plain`` give the candidate
counts of the reference's ``segmented_query`` (xla) and
``sharded_query_vmap_reference``, fresh and after delete, insert and
compact, at T = 1 and T = 8, S = 2 and S = 4. Float stages are held to
``parity.rerank_bound``'s dense case (a dot of prod d products per score):
scores, and ids equal except at near ties. The reference's Pallas K1 in
interpret mode is compiled four times in this module (one per kind, T = 1,
fresh; ROADMAP.md R3). End to end, ``build_service`` over the dense corpus
for every kind: self-queries return themselves, recall@k within 0.05 of
the reference service's.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grids
import torch_bridge as tb
from repro.core import DeviceLSHIndex as JaxIndex
from repro.core import ShardedLSHIndex as JaxSharded
from repro.core import projections as jproj
from repro.core import recall_at_k as jax_recall
from repro.core import segments as jseg
from repro.kernels import fused_query as jfq
from repro.serving.lsh_service import build_service as jax_build_service
from repro_torch.core import recall_at_k as torch_recall
from repro_torch.core import segments as tseg
from repro_torch.core.index import DeviceLSHIndex, ShardedLSHIndex
from repro_torch.core.tensor_formats import as_batch
from repro_torch.kernels import parity
from repro_torch.kernels.fused_query import (fused_query_plain,
                                             fused_query_sharded_plain)
from repro_torch.serving.lsh_service import build_service

N, B, TOPK = 59, 7, 5
KINDS = ("e2lsh", "srp", "cp-e2lsh", "tt-srp")


def _data(seed=0, n=N, b=B):
    corpus, queries = grids.corpus_and_queries(n, b, seed=seed)
    return np.array(corpus), np.array(queries)


def _mutate(idx, corpus, wrap):
    """test_fused_probe.py's mutation: deletes, then the first 7 items
    (scaled by 1.01) as one delta."""
    idx.delete(np.arange(0, 12, 3))
    idx.insert(wrap(corpus[:7] * 1.01))
    return idx


@pytest.fixture(scope="module", params=KINDS)
def case(request):
    kind = request.param
    metric = grids.metric_for(kind)
    fam = grids.grid_family(kind, num_tables=4, hash_backend="xla")
    corpus, queries = _data()
    return dict(kind=kind, metric=metric, fam=fam, tfam=tb.bridge_family(fam),
                corpus=corpus, queries=queries,
                values=torch.from_numpy(np.array(jproj.project_batch(
                    fam.projection, jnp.asarray(queries)))))


def _assert_matches(case, got, ref, corpus):
    ids, sc, nc = got
    ref_ids, ref_sc, ref_nc = (np.array(a) for a in ref)
    np.testing.assert_array_equal(nc.numpy(), ref_nc)
    tq = as_batch(torch.from_numpy(case["queries"]))
    tol = parity.rerank_bound(case["metric"], tq, corpus,
                              torch.from_numpy(ref_ids),
                              torch.from_numpy(ref_sc))
    keep = (ids.numpy() == ref_ids) & (ref_ids >= 0)
    assert (np.abs(sc.numpy()[keep] - ref_sc[keep])
            <= tol.numpy()[keep]).all()
    assert parity.topk_mismatches(ids, sc, torch.from_numpy(ref_ids),
                                  torch.from_numpy(ref_sc), tol) == 0
    assert (ref_ids >= 0).any()


def test_dense_sorted_tables_bitwise(case):
    idx = JaxIndex(case["fam"], metric=case["metric"],
                   probe_backend="xla").build(jnp.asarray(case["corpus"]))
    base = idx.store.view.base
    keys = torch.from_numpy(np.asarray(base.keys).astype(np.int64))
    seg = tseg.build_segment(keys, as_batch(torch.from_numpy(case["corpus"])))
    np.testing.assert_array_equal(seg.sorted_keys.numpy(),
                                  np.asarray(base.sorted_keys))
    np.testing.assert_array_equal(seg.perm.numpy(), np.asarray(base.perm))
    assert seg.cap == base.cap
    assert seg.stacked.shape == (N, 64) and seg.corpus.layout == "dense"
    assert seg.corpus.data.untyped_storage().data_ptr() == \
        seg.stacked.untyped_storage().data_ptr()


@pytest.mark.parametrize("state", ["fresh", "mutated", "compacted"])
@pytest.mark.parametrize("probes", [1, 8])
def test_plain_vs_reference_segmented_query(case, state, probes):
    """The carried store (``bucket_cap`` 4: live windows) and the
    reference's raw values through ``fused_query_plain``, against the
    reference's xla ``segmented_query``."""
    idx = JaxIndex(case["fam"], metric=case["metric"], bucket_cap=4,
                   probe_backend="xla").build(jnp.asarray(case["corpus"]))
    if state != "fresh":
        _mutate(idx, case["corpus"], jnp.asarray)
    if state == "compacted":
        idx.compact()
    view = idx.store.view
    mults = idx._mults
    ref = jseg.segmented_query(
        case["fam"], view.all_arrays, jnp.asarray(mults),
        jnp.asarray(case["queries"]), metric=case["metric"], topk=TOPK,
        caps=view.all_caps, probes=probes, probe_backend="xla")
    store = tb.carry_store(idx.store)
    tq = as_batch(torch.from_numpy(case["queries"]))
    tfam = case["tfam"]
    got = fused_query_plain(
        case["values"], tfam.offsets, torch.from_numpy(mults.astype(np.int64)),
        tq.stack(), store.view.all_arrays, kind=case["kind"],
        w=tfam.bucket_width, num_tables=tfam.num_tables,
        num_codes=tfam.num_codes, metric=case["metric"], topk=TOPK,
        caps=store.view.all_caps, probes=probes)
    _assert_matches(case, got, ref, store.effective_corpus())
    assert len(store.view.segments) == (2 if state == "mutated" else 1)


def test_plain_vs_reference_pallas_kernel(case):
    """The reference's K1 (``fused_query``, interpret mode) on the dense
    rows against ``fused_query_plain``'s dense branch."""
    idx = JaxIndex(case["fam"], metric=case["metric"],
                   probe_backend="pallas").build(jnp.asarray(case["corpus"]))
    view = idx.store.view
    ref = jfq.fused_query(case["fam"], view.all_arrays,
                          jnp.asarray(idx._mults),
                          jnp.asarray(case["queries"]), metric=case["metric"],
                          topk=TOPK, caps=view.all_caps, probes=1,
                          interpret=True)
    store = tb.carry_store(idx.store)
    tfam = case["tfam"]
    got = fused_query_plain(
        case["values"], tfam.offsets,
        torch.from_numpy(idx._mults.astype(np.int64)),
        as_batch(torch.from_numpy(case["queries"])).stack(),
        store.view.all_arrays, kind=case["kind"], w=tfam.bucket_width,
        num_tables=tfam.num_tables, num_codes=tfam.num_codes,
        metric=case["metric"], topk=TOPK, caps=store.view.all_caps)
    _assert_matches(case, got, ref, store.effective_corpus())


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_plain_vs_reference(case, shards):
    """A mutated sharded store (a padded last shard, a routed slab), carried
    across, through ``fused_query_sharded_plain`` at T = 1 and 8, against
    the reference's ``sharded_query_vmap_reference``."""
    idx = JaxSharded(case["fam"], metric=case["metric"], shards=shards,
                     probe_backend="xla").build(jnp.asarray(case["corpus"]))
    _mutate(idx, case["corpus"], jnp.asarray)
    view = idx.store.view
    store = tb.carry_store(idx.store)
    tview = store.view
    tfam = case["tfam"]
    for probes in (1, 8):
        ref = jseg.sharded_query_vmap_reference(
            case["fam"], view.seg_arrays(0), view.delta_arrays,
            jnp.asarray(idx._mults), jnp.asarray(case["queries"]),
            metric=case["metric"], topk=TOPK, cap=view.base.cap,
            delta_caps=view.delta_caps, probes=probes)
        got = fused_query_sharded_plain(
            case["values"], tfam.offsets,
            torch.from_numpy(idx._mults.astype(np.int64)),
            as_batch(torch.from_numpy(case["queries"])).stack(),
            tview.seg_arrays(0), tview.delta_arrays, kind=case["kind"],
            w=tfam.bucket_width, num_tables=tfam.num_tables,
            num_codes=tfam.num_codes, metric=case["metric"], topk=TOPK,
            cap=tview.base.cap, delta_caps=tview.delta_caps, probes=probes)
        _assert_matches(case, got, ref, store.effective_corpus())
    assert len(tview.k1_segments[0]) == shards * 2


def test_port_sharded_equals_single_device(case):
    """The port's own indexes over the dense corpus: S = 2 and 4 answer as
    the single-device index (ids and counts bitwise), fresh, mutated and
    after ``rebalance()``."""
    tfam, metric = case["tfam"], case["metric"]
    corpus = torch.from_numpy(case["corpus"])
    tq = torch.from_numpy(case["queries"])
    single = DeviceLSHIndex(tfam, metric=metric).build(corpus)
    want = single.query_batch(tq, TOPK, probes=3)
    _mutate(single, corpus, lambda x: x)
    want_m = single.query_batch(tq, TOPK, probes=3)
    for shards in (2, 4):
        sh = ShardedLSHIndex(tfam, metric=metric, shards=shards).build(corpus)
        for w_, g in zip(want, sh.query_batch(tq, TOPK, probes=3)):
            np.testing.assert_array_equal(g.numpy(), w_.numpy())
        _mutate(sh, corpus, lambda x: x)
        for state in ("mutated", "rebalanced"):
            got = sh.query_batch(tq, TOPK, probes=3)
            np.testing.assert_array_equal(got[0].numpy(), want_m[0].numpy())
            np.testing.assert_array_equal(got[2].numpy(), want_m[2].numpy())
            sh.rebalance()
        assert sh.rebalances == 2


def test_service_self_queries_and_recall(case):
    """``build_service`` over the dense corpus (a plain tensor): every item
    queried as itself comes back first, and recall@k within 0.05 of the
    reference service's on the carried family."""
    corpus, queries = _data(seed=1, n=97, b=11)
    k, w = (3, 6.0) if case["kind"].endswith("e2lsh") else (6, 1.0)
    kw = dict(metric=case["metric"], num_codes=k, num_tables=4,
              bucket_width=w)
    jsvc = jax_build_service(tb.jax_key(42), case["kind"], grids.DIMS,
                             jnp.asarray(corpus), rank=2, device=True,
                             hash_backend="xla", probe_backend="xla", **kw)
    svc = build_service(None, case["kind"], grids.DIMS,
                        torch.from_numpy(corpus),
                        family=tb.bridge_family(jsvc.index.family),
                        device="cpu", **kw)
    ids, _, n_cand = svc.query_arrays(torch.from_numpy(corpus), topk=1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(97))
    got = torch_recall(svc.index, torch.from_numpy(queries), TOPK)
    ref = jax_recall(jsvc.index, jnp.asarray(queries), TOPK)
    assert abs(got["recall"] - ref["recall"]) <= 0.05
    assert got["corpus_size"] == ref["corpus_size"] == 97
