"""Port parity: queries in a format other than the corpus's (K1's and
K1s's cross-format re-rank in their plain versions, the pair-dispatching
``recall_at_k`` / ``brute_force_batch`` and the service) against the
reference.

One clustered CP fixture (``torch_bridge.cp_fixture``) gives every format
exactly: TT by ``tensor_formats.cp_to_tt`` (diagonal cores), dense by
densifying. Given the reference's store over a corpus (carried over with
``torch_bridge.carry_store``) and its raw projections of the queries,
``fused_query_plain`` gives the candidate counts of the reference's K1
bitwise, and its scores and ids within ``parity.rerank_bound``'s cross
terms (ids equal except at near ties):

  * against the reference's Pallas ``fused_query`` in interpret mode for
    dense x CP, CP x dense, CP x TT and TT x CP (query x corpus; the four
    reference Pallas compilations of this module, ROADMAP.md R3);
  * against the reference's xla ``segmented_query`` for dense x TT and TT x
    dense, fresh at T = 1 and with a ``bucket_cap`` live window at T = 8;
  * ``fused_query_sharded_plain`` at S = 2 against
    ``sharded_query_vmap_reference``.

End to end, ``build_service`` over CP, TT and dense corpora answers queries
of the other two formats (ROADMAP.md F3) at ``shards=None`` and 2, with
recall@k within 0.05 of the reference service's.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import DeviceLSHIndex as JaxIndex
from repro.core import ShardedLSHIndex as JaxSharded
from repro.core import projections as jproj
from repro.core import recall_at_k as jax_recall
from repro.core import segments as jseg
from repro.kernels import fused_query as jfq
from repro.serving.lsh_service import build_service as jax_build_service
from repro_torch.core import recall_at_k as torch_recall
from repro_torch.core.index import brute_force_batch
from repro_torch.core.projections import densify_batch
from repro_torch.core.tensor_formats import DenseTensor, cp_to_tt
from repro_torch.kernels import parity
from repro_torch.kernels.fused_query import (fused_query_plain,
                                             fused_query_sharded_plain)
from repro_torch.serving.lsh_service import build_service

N, B, TOPK = 61, 8, 5
DIMS = tb.DIMS
# the family that indexes each corpus format, and its metric
KIND = {"cp": ("cp-e2lsh", "euclidean"), "tt": ("tt-srp", "cosine"),
        "dense": ("cp-e2lsh", "cosine")}


def _formats(factors):
    """CP factor arrays (n, d, R) -> {format: port tensor}, all exactly one
    tensor each: the CP tensor, its TT copy, its dense rows."""
    from repro_torch.core.tensor_formats import CPTensor
    cp = CPTensor(tuple(torch.from_numpy(f) for f in factors), 1.0)
    dense = densify_batch(cp).reshape((-1,) + DIMS)
    return {"cp": cp, "tt": cp_to_tt(cp), "dense": DenseTensor(dense, DIMS)}


def _ref(x):
    """A port tensor -> the reference's (a jnp array for dense rows)."""
    from repro.core.tensor_formats import CPTensor as JaxCP
    from repro.core.tensor_formats import TTTensor as JaxTT
    if x.layout == "dense":
        return jnp.asarray(x.data.numpy())
    cls = JaxCP if x.layout == "cp" else JaxTT
    return cls(tuple(jnp.asarray(a.numpy()) for a in x.leaves), x.scale)


@pytest.fixture(scope="module")
def data():
    corpus, queries = tb.cp_fixture(N, B, seed=5)
    return _formats(corpus), _formats(queries)


def _setup(data, qf, cf, backend, **index_kw):
    corpus, queries = data
    kind, metric = KIND[cf]
    fam = tb.jax_family(kind, backend="xla")
    idx = (JaxSharded if "shards" in index_kw else JaxIndex)(
        fam, metric=metric, probe_backend=backend, **index_kw).build(
            _ref(corpus[cf]))
    q = queries[qf]
    values = torch.from_numpy(np.array(jproj.project_batch(fam.projection,
                                                           _ref(q))))
    return dict(fam=fam, tfam=tb.bridge_family(fam), idx=idx, metric=metric,
                kind=kind, q=q, values=values, store=tb.carry_store(idx.store),
                mults=torch.from_numpy(idx._mults.astype(np.int64)))


def _kw(s, probes=1):
    tfam = s["tfam"]
    return dict(kind=s["kind"], w=tfam.bucket_width,
                num_tables=tfam.num_tables, num_codes=tfam.num_codes,
                metric=s["metric"], topk=TOPK, probes=probes)


def _assert_matches(s, got, ref):
    ids, sc, nc = got
    ref_ids, ref_sc, ref_nc = (torch.from_numpy(np.array(a)) for a in ref)
    np.testing.assert_array_equal(nc.numpy(), ref_nc.numpy().reshape(-1))
    tol = parity.rerank_bound(s["metric"], s["q"],
                              s["store"].effective_corpus(), ref_ids, ref_sc)
    keep = (ids == ref_ids) & (ref_ids >= 0)
    assert ((sc - ref_sc).abs()[keep] <= tol[keep]).all()
    assert parity.topk_mismatches(ids, sc, ref_ids, ref_sc, tol) == 0
    assert (ref_ids[:, 0] == torch.arange(B)).float().mean() >= 0.75


@pytest.mark.parametrize("qf,cf", [("dense", "cp"), ("cp", "dense"),
                                   ("cp", "tt"), ("tt", "cp")])
def test_plain_vs_reference_pallas_kernel(data, qf, cf):
    """``fused_query_plain`` on a query batch of another format against the
    reference's K1 (``fused_query``, interpret mode) on the same corpus."""
    s = _setup(data, qf, cf, "pallas")
    view = s["idx"].store.view
    ref = jfq.fused_query(s["fam"], view.all_arrays,
                          jnp.asarray(s["idx"]._mults), _ref(s["q"]),
                          metric=s["metric"], topk=TOPK, caps=view.all_caps,
                          probes=1, interpret=True)
    got = fused_query_plain(s["values"], s["tfam"].offsets, s["mults"],
                            s["q"].stack(), s["store"].view.all_arrays,
                            caps=s["store"].view.all_caps, **_kw(s))
    _assert_matches(s, got, ref)


@pytest.mark.parametrize("cap,probes", [(None, 1), (4, 8)])
@pytest.mark.parametrize("qf,cf", [("dense", "tt"), ("tt", "dense")])
def test_plain_vs_reference_segmented_query(data, qf, cf, cap, probes):
    """``fused_query_plain`` against the reference's xla
    ``segmented_query``: the exact cap at T = 1, and a live window at
    T = 8."""
    s = _setup(data, qf, cf, "xla", bucket_cap=cap)
    view = s["idx"].store.view
    ref = jseg.segmented_query(
        s["fam"], view.all_arrays, jnp.asarray(s["idx"]._mults),
        _ref(s["q"]), metric=s["metric"], topk=TOPK, caps=view.all_caps,
        probes=probes, probe_backend="xla")
    tview = s["store"].view
    assert (tview.all_arrays[0].win is not None) == (cap is not None)
    got = fused_query_plain(s["values"], s["tfam"].offsets, s["mults"],
                            s["q"].stack(), tview.all_arrays,
                            caps=tview.all_caps, **_kw(s, probes))
    _assert_matches(s, got, ref)


@pytest.mark.parametrize("qf,cf", [("dense", "cp"), ("tt", "cp"),
                                   ("cp", "tt")])
def test_sharded_plain_vs_reference(data, qf, cf):
    """``fused_query_sharded_plain`` over a 2-shard store (a padded last
    shard) against the reference's ``sharded_query_vmap_reference`` at
    T = 1 and T = 4."""
    s = _setup(data, qf, cf, "xla", shards=2)
    view = s["idx"].store.view
    tview = s["store"].view
    for probes in (1, 4):
        ref = jseg.sharded_query_vmap_reference(
            s["fam"], view.seg_arrays(0), view.delta_arrays,
            jnp.asarray(s["idx"]._mults), _ref(s["q"]), metric=s["metric"],
            topk=TOPK, cap=view.base.cap, delta_caps=view.delta_caps,
            probes=probes)
        got = fused_query_sharded_plain(
            s["values"], s["tfam"].offsets, s["mults"], s["q"].stack(),
            tview.seg_arrays(0), tview.delta_arrays, cap=tview.base.cap,
            delta_caps=tview.delta_caps, **_kw(s, probes))
        _assert_matches(s, got, ref)


@pytest.mark.parametrize("cf", ["cp", "tt", "dense"])
def test_service_answers_every_query_format(data, cf):
    """``build_service`` over a corpus of each format (the F3 repro: a
    cp-e2lsh service at (4, 4, 4)) answers queries of all three formats at
    ``shards=None`` and 2: the same ids for one tensor in any format
    except at near ties, the planted neighbour first, recall@k within 0.05
    of the reference service's on the carried family, and
    ``brute_force_batch`` across formats equal to it in-format."""
    corpus, queries = data
    kw = dict(metric="euclidean", num_codes=3, num_tables=4, bucket_width=6.0)
    jsvc = jax_build_service(tb.jax_key(42), "cp-e2lsh", DIMS,
                             _ref(corpus[cf]), rank=2, device=True,
                             hash_backend="xla", probe_backend="xla", **kw)
    fam = tb.bridge_family(jsvc.index.family)
    truth, _ = brute_force_batch("euclidean", queries["cp"], corpus[cf], TOPK)
    for shards in (None, 2):
        svc = build_service(None, "cp-e2lsh", DIMS, corpus[cf], family=fam,
                            shards=shards, device="cpu", **kw)
        want = svc.query_arrays(queries["cp"], topk=TOPK)
        for qf, q in queries.items():
            ids, scores, n_cand = svc.query_arrays(q, topk=TOPK)
            np.testing.assert_array_equal(ids[:, 0], np.arange(B))
            assert (ids == want[0]).mean() >= 0.9, (cf, qf, shards)
            got = torch_recall(svc.index, q, TOPK)
            ref = jax_recall(jsvc.index, _ref(q), TOPK)
            assert abs(got["recall"] - ref["recall"]) <= 0.05, (cf, qf)
            bf, _ = brute_force_batch("euclidean", q, corpus[cf], TOPK)
            assert (bf == truth).mean() >= 0.95, (cf, qf)


def test_launch_shapes_cover_the_built_instantiations():
    """``fused_query.SHAPES`` holds exactly the instantiations that
    ``csrc/fused_query.cu`` (same-format) and ``csrc/fused_query_mixed.cu``
    (``K1_MIXED_PAIRS`` in ``csrc/fused_query.cuh``) build, and ``instance``
    maps every (corpus, query) format pair at every TT rank K1 takes, with
    short and long TT and CP rows, onto one of them (the C launch
    refuses a plan whose threads, blocks or shared bytes differ)."""
    import itertools
    import re
    from pathlib import Path

    from repro_torch.kernels import fused_query as fq
    csrc = Path(fq.__file__).parent / "csrc"

    def num(token):
        return fq.DENSE if token == "kDense" else int(token)

    same = {(num(a), num(b)) for a, b in re.findall(
        r"launch<(\w+), (\w+)>\(a, smem, st\)",
        (csrc / "fused_query.cu").read_text())}
    macro = re.search(r"#define K1_MIXED_PAIRS\(X\)(.*?)\n\n",
                      (csrc / "fused_query.cuh").read_text(), re.S)
    mixed = {(num(a), num(b))
             for a, b in re.findall(r"X\((\w+), (\w+)\)", macro.group(1))}
    assert all(tr == qr for tr, qr in same) and len(same) == 5
    assert all(tr != qr for tr, qr in mixed) and len(mixed) == 9
    assert set(fq.SHAPES) == same | mixed
    layouts = ("cp", "tt", "dense")
    for layout, ql in itertools.product(layouts, layouts):
        for rq, rc in itertools.product(range(1, fq.MAX_TT_RANK + 1),
                                        repeat=2):
            rq_ = rq if ql == "tt" else 1 if ql == "dense" else 4
            rc_ = rc if layout == "tt" else 1 if layout == "dense" else 4
            for n, d in ((3, 12), (3, 64)):
                assert fq.instance(layout, ql, rq_, rc_, n, d) in fq.SHAPES
