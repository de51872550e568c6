"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA card and ``nvcc`` (the kernels build
at first use for sm_90a) and skip elsewhere, deciding inside a fixture.
Run them on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

K3 (``cp_gram``) and K4 (``tt_inner``), also at the ranks of
benchmarks/kernels.py (32 and 16: the warp kernels) and at K = 2000 / 1024
hashes in one table (tiled over blocks): raw values within
``parity.raw_bound`` / ``parity.tt_raw_bound``; codes, keys and packed
words equal except where a value lies within that bound of a bucket edge
(E2LSH) or of 0 (SRP). K1 (``fused_query``, CP and TT re-rank): on the same
raw values and segment arrays, candidate counts equal bit for bit, scores
within ``parity.rerank_bound``, ids equal except at near ties; so also on
its multi-probe (T = 8, dense window), live-window (``bucket_cap``, after
deletes) and multi-segment (a base and eight deltas) branches, at TT
rank 16, and with a window past one block's shared memory (the spill
branch, which also equals the shared branch bit for bit where both run,
for K1 and K1s, CP and TT). K6 (``srp_pack``) and K7 (``e2lsh_quant``)
equal their plain versions bit for bit, ragged shapes included. K1s
(``fused_query_sharded``, K1's kernel over every (shard, segment) pair):
against its plain version on S = 3 stores with a padded last shard, two
routed slabs, deletes and live windows at T in {1, 4}, CP and TT; and with
the exact cap its answers equal the single-device index's bit for bit.
"""

import pytest
import torch

from repro_torch.core.projections import (sample_cp_projection,
                                          sample_tt_projection)
from repro_torch.core.tensor_formats import (TTTensor, cp_random_data,
                                             tt_random_data)
from repro_torch.kernels import parity
from repro_torch.kernels import fused_query as fq_mod
from repro_torch.kernels import ops
from repro_torch.kernels.cp_gram import cp_gram, cp_gram_plain
from repro_torch.kernels.e2lsh_quant import e2lsh_quant, e2lsh_quant_plain
from repro_torch.kernels.epilogues import EPILOGUES
from repro_torch.kernels.fused_query import (fused_query, fused_query_plain,
                                             fused_query_sharded,
                                             fused_query_sharded_plain)
from repro_torch.kernels.srp_pack import srp_pack, srp_pack_plain
from repro_torch.kernels.ops import (_stack_cp_batch, _stack_cp_proj,
                                     _stack_tt_batch, _stack_tt_proj,
                                     stack_cp)
from repro_torch.kernels.tt_inner import tt_inner, tt_inner_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run on the card "
                    "only (no interpret mode)")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dims,b,l,k,rx,rp", [
    ((12, 12, 12), 3000, 10, 10, 4, 3),   # the serving shape, a ragged batch
    ((5, 7, 3), 37, 3, 5, 2, 3),          # unequal modes, odd sizes
    ((4, 4, 4, 4), 129, 2, 40, 1, 2),     # 4 modes, two packed words
    ((64, 64, 64, 64), 64, 8, 8, 32, 32),  # benchmarks/kernels.py: rank 32
    ((6, 6, 6), 70, 2, 40, 12, 3),        # ranks above 8, two words
    ((8, 8, 8), 300, 1, 2000, 2, 2),      # collision.py: K tiled over blocks
])
def test_cp_gram_matches_plain(gen, dims, b, l, k, rx, rp):
    x = _stack_cp_batch(cp_random_data(gen, dims, rx, batch=b))
    proj = sample_cp_projection(gen, l * k, dims, rp)
    p = _stack_cp_proj(proj, l)
    w = 2.0
    offs = torch.rand((l, k), generator=gen, device="cuda") * w
    mults = torch.randint(0, 1 << 32, (k,), generator=gen, device="cuda",
                          dtype=torch.int64) | 1
    scale = proj.scale
    raw = cp_gram(x, p, epilogue="raw", scale=scale)
    raw_p = cp_gram_plain(x, p, epilogue="raw", scale=scale)
    torch.cuda.synchronize()
    bound = parity.raw_bound(x, p, scale)
    assert bool(((raw - raw_p).abs() <= bound).all())
    for kind, epi in (("cp-e2lsh", "e2lsh"), ("cp-srp", "srp")):
        near = parity.boundary_codes(raw_p, bound, kind, offs, w)
        codes = cp_gram(x, p, offs, mults, epilogue=epi, w=w, scale=scale)
        codes_p = cp_gram_plain(x, p, offs, mults, epilogue=epi, w=w,
                                scale=scale)
        assert bool(((codes == codes_p) | near).all())
        keys = cp_gram(x, p, offs, mults, epilogue=epi + "-keys", w=w,
                       scale=scale)
        keys_p = cp_gram_plain(x, p, offs, mults, epilogue=epi + "-keys",
                               w=w, scale=scale)
        assert parity.key_mismatches(keys, keys_p, near)[0] == 0
    words = cp_gram(x, p, epilogue="srp-packed", scale=scale)
    words_p = cp_gram_plain(x, p, epilogue="srp-packed", scale=scale)
    near = parity.boundary_codes(raw_p, bound, "cp-srp").any(-1)
    assert bool(((words == words_p).all(-1) | near).all())


@pytest.mark.parametrize("kind,metric,n,k,l,w", [
    ("cp-e2lsh", "euclidean", 20000, 8, 6, 2.0),
    ("cp-srp", "cosine", 5000, 10, 4, 1.0),
    ("cp-e2lsh", "cosine", 3001, 4, 3, 4.0),
])
def test_fused_query_matches_plain(gen, kind, metric, n, k, l, w):
    from repro_torch.serving.lsh_service import build_service
    dims = (6, 6, 6)
    corpus = cp_random_data(gen, dims, 3, batch=n)
    svc = build_service(gen, kind, dims, corpus, metric=metric, num_codes=k,
                        num_tables=l, rank=2, bucket_width=w)
    qid = torch.randint(0, n, (300,), generator=gen, device="cuda")
    q = corpus.index(qid)
    q = type(q)(tuple(f + 0.05 * torch.randn(f.shape, generator=gen,
                                             device="cuda")
                      for f in q.factors), 1.0)
    fam, idx = svc.index.family, svc.index
    seg = idx.store.seg_arrays(0)
    qs = stack_cp(q)
    values = fam.raw_stacked(qs[1], q.scale)
    offs, mults = fam.offsets, idx._mults_t
    kw = dict(kind=kind, w=fam.bucket_width, num_tables=l, num_codes=k,
              metric=metric, topk=10, caps=(idx.cap,))
    ids, sc, nc = fused_query(values, offs, mults, qs, (seg,), **kw)
    ids_p, sc_p, nc_p = fused_query_plain(values, offs, mults, qs, (seg,),
                                          **kw)
    torch.cuda.synchronize()
    assert torch.equal(nc, nc_p)
    tol = parity.rerank_bound(metric, q, seg.corpus, ids_p, sc_p)
    same = (ids == ids_p) & (ids_p >= 0)
    assert bool(((sc - sc_p).abs()[same] <= tol[same]).all())
    assert parity.topk_mismatches(ids, sc, ids_p, sc_p, tol) == 0
    # an item queried as itself lands in its own bucket of every table
    self_ids, _, _ = svc.index.query_batch(corpus.index(qid[:64]), topk=1)
    assert torch.equal(self_ids[:, 0].long(), qid[:64])



@pytest.mark.parametrize("dims,b,l,k,rx,rp", [
    ((16, 16, 16, 16), 3000, 10, 10, 4, 4),  # the TT cell, a ragged batch
    ((5, 7, 3), 37, 3, 5, 3, 2),             # unequal modes and ranks
    ((6, 6), 65, 2, 7, 4, 3),                # N = 2: both cores boundary
    ((4, 4, 4, 4), 129, 2, 40, 2, 2),        # two packed words
    ((3, 3, 3), 50, 2, 3, 6, 8),             # ranks above 4: RT = 8
    ((32, 32, 32, 32), 32, 4, 8, 16, 16),    # benchmarks/kernels.py: rank 16
    ((6, 6, 6), 40, 2, 5, 12, 3),            # ranks above 8, the warp kernel
    ((8, 8, 8), 300, 1, 1024, 2, 2),         # K > 512 tiled over blocks
])
def test_tt_inner_matches_plain(gen, dims, b, l, k, rx, rp):
    x = _stack_tt_batch(tt_random_data(gen, dims, rx, batch=b))
    proj = sample_tt_projection(gen, l * k, dims, rp)
    p = _stack_tt_proj(proj, l)
    w = 2.0
    offs = torch.rand((l, k), generator=gen, device="cuda") * w
    mults = torch.randint(0, 1 << 32, (k,), generator=gen, device="cuda",
                          dtype=torch.int64) | 1
    scale = proj.scale
    raw_p = tt_inner_plain(x, p, epilogue="raw", scale=scale)
    bound = parity.tt_raw_bound(x, p, scale)
    for epi in EPILOGUES:
        got = tt_inner(x, p, offs, mults, epilogue=epi, w=w, scale=scale)
        want = tt_inner_plain(x, p, offs, mults, epilogue=epi, w=w,
                              scale=scale)
        torch.cuda.synchronize()
        kind = "tt-srp" if epi.startswith("srp") else "tt-e2lsh"
        near = parity.boundary_codes(raw_p, bound, kind, offs, w)
        if epi == "raw":
            assert bool(((got - want).abs() <= bound).all())
        elif epi in ("e2lsh", "srp"):
            assert bool(((got == want) | near).all())
        elif epi.endswith("keys"):
            assert parity.key_mismatches(got, want, near)[0] == 0
        else:
            assert bool(((got == want).all(-1) | near.any(-1)).all())


@pytest.mark.parametrize("kind,metric,n,k,l,w,rhat", [
    ("tt-e2lsh", "euclidean", 20000, 8, 6, 8.0, 3),
    ("tt-srp", "cosine", 5000, 10, 4, 1.0, 3),
    ("tt-srp", "euclidean", 5000, 10, 4, 1.0, 6),   # ranks above 4: TR = 8
    ("tt-srp", "euclidean", 5000, 10, 4, 1.0, 16),  # ranks above 8: TR = 16
])
def test_fused_query_tt_matches_plain(gen, kind, metric, n, k, l, w, rhat):
    from repro_torch.serving.lsh_service import build_service
    dims = (8, 8, 8)
    corpus = tt_random_data(gen, dims, rhat, batch=n)
    svc = build_service(gen, kind, dims, corpus, metric=metric, num_codes=k,
                        num_tables=l, rank=2, bucket_width=w)
    qid = torch.randint(0, n, (300,), generator=gen, device="cuda")
    q = corpus.index(qid)
    q = TTTensor(tuple(c + 0.05 * torch.randn(c.shape, generator=gen,
                                              device="cuda")
                       for c in q.cores), 1.0)
    fam, idx = svc.index.family, svc.index
    seg = idx.store.seg_arrays(0)
    qs = q.stack()
    values = fam.raw_stacked(qs[1], q.scale)
    offs, mults = fam.offsets, idx._mults_t
    kw = dict(kind=kind, w=fam.bucket_width, num_tables=l, num_codes=k,
              metric=metric, topk=10, caps=(idx.cap,))
    ids, sc, nc = fused_query(values, offs, mults, qs, (seg,), **kw)
    ids_p, sc_p, nc_p = fused_query_plain(values, offs, mults, qs, (seg,),
                                          **kw)
    torch.cuda.synchronize()
    assert torch.equal(nc, nc_p)
    assert int(nc.sum()) > 300
    tol = parity.rerank_bound(metric, q, seg.corpus, ids_p, sc_p)
    same = (ids == ids_p) & (ids_p >= 0)
    assert bool(((sc - sc_p).abs()[same] <= tol[same]).all())
    assert parity.topk_mismatches(ids, sc, ids_p, sc_p, tol) == 0
    self_ids, _, _ = svc.index.query_batch(corpus.index(qid[:64]), topk=1)
    assert torch.equal(self_ids[:, 0].long(), qid[:64])


def _k1_vs_plain(svc, q, probes):
    """K1 against its plain version over every segment of the service's
    store, on the same raw values -> the kernel's candidate counts."""
    idx = svc.index
    fam, view = idx.family, idx.store.view
    qs = q.stack()
    values = fam.raw_stacked(qs[1], q.scale)
    kw = dict(kind=fam.kind, w=fam.bucket_width, num_tables=fam.num_tables,
              num_codes=fam.num_codes, metric=idx.metric, topk=10,
              caps=view.all_caps, probes=probes)
    ids, sc, nc = fused_query(values, fam.offsets, idx._mults_t, qs,
                              view.all_arrays, table=view.k1_table, **kw)
    ids_p, sc_p, nc_p = fused_query_plain(values, fam.offsets, idx._mults_t,
                                          qs, view.all_arrays, **kw)
    torch.cuda.synchronize()
    assert torch.equal(nc, nc_p)
    tol = parity.rerank_bound(idx.metric, q, idx.effective_corpus(), ids_p,
                              sc_p)
    same = (ids == ids_p) & (ids_p >= 0)
    assert bool(((sc - sc_p).abs()[same] <= tol[same]).all())
    assert parity.topk_mismatches(ids, sc, ids_p, sc_p, tol) == 0
    assert bool((ids < idx.size).all())
    return nc


def _planted(gen, corpus, n, b):
    qid = torch.randint(0, n, (b,), generator=gen, device="cuda")
    q = corpus.index(qid)
    return type(q)(tuple(f + 0.05 * torch.randn(f.shape, generator=gen,
                                                device="cuda")
                         for f in q.leaves), 1.0)


@pytest.mark.parametrize("kind,metric,probes", [
    ("cp-e2lsh", "euclidean", 8), ("cp-srp", "cosine", 8),
    ("cp-e2lsh", "cosine", 3)])
def test_fused_query_multiprobe_matches_plain(gen, kind, metric, probes):
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 6, 6), 20000
    corpus = cp_random_data(gen, dims, 3, batch=n)
    svc = build_service(gen, kind, dims, corpus, metric=metric, num_codes=8,
                        num_tables=2, rank=2, bucket_width=2.0,
                        probes=probes)
    q = _planted(gen, corpus, n, 300)
    nc = _k1_vs_plain(svc, q, probes)
    nc1 = _k1_vs_plain(svc, q, 1)
    assert bool((nc >= nc1).all()) and int(nc.sum()) > int(nc1.sum())
    assert fused_query.branches["multiprobe"] > 0


@pytest.mark.parametrize("layout", ["cp", "tt"])
def test_fused_query_live_window_matches_plain(gen, layout):
    from repro_torch.serving.lsh_service import build_service
    n = 20000
    if layout == "cp":
        dims, kind, w = (6, 6, 6), "cp-e2lsh", 2.0
        corpus = cp_random_data(gen, dims, 3, batch=n)
    else:
        dims, kind, w = (8, 8, 8), "tt-e2lsh", 8.0
        corpus = tt_random_data(gen, dims, 3, batch=n)
    svc = build_service(gen, kind, dims, corpus, num_codes=6, num_tables=4,
                        rank=2, bucket_width=w, bucket_cap=16)
    assert svc.index.store.view.wins[0] is not None
    svc.delete(torch.randperm(n, generator=gen, device="cuda")[:n // 3])
    q = _planted(gen, corpus, n, 300)
    for probes in (1, 4):
        nc = _k1_vs_plain(svc, q, probes)
        assert int(nc.sum()) > 0
    assert fused_query.branches["live_window"] > 0


@pytest.mark.parametrize("layout", ["cp", "tt"])
def test_fused_query_nine_segments_match_plain(gen, layout):
    """A base and eight deltas (max_deltas = 8: none compacts), deletes in
    the base and in the deltas, T = 4, live windows."""
    from repro_torch.serving.lsh_service import build_service
    n = 16384
    data = cp_random_data if layout == "cp" else tt_random_data
    dims = (6, 6, 6) if layout == "cp" else (8, 8, 8)
    kind = f"{layout}-e2lsh"
    w = 2.0 if layout == "cp" else 8.0
    corpus = data(gen, dims, 3, batch=n)
    svc = build_service(gen, kind, dims, corpus, num_codes=8, num_tables=4,
                        rank=2, bucket_width=w, bucket_cap=32, max_deltas=8,
                        probes=4)
    inserted = [data(gen, dims, 3, batch=512) for _ in range(8)]
    for batch in inserted:
        svc.insert(batch)
    assert len(svc.index.store.deltas) == 8
    svc.delete(torch.arange(0, n + 8 * 512, 7, device="cuda"))
    q = _planted(gen, inserted[3], 512, 128)
    nc = _k1_vs_plain(svc, q, 4)
    assert int(nc.sum()) > 0 and fused_query.branches["segments"] > 0
    ids, _, _ = svc.query_arrays(q, topk=1)
    assert (ids[:, 0] >= 0).mean() > 0.5


def test_fused_query_window_limit_raises(gen):
    """One segment's L*T*cap beyond one block's shared memory (8 * 2 * 2048
    = 32768 slots): K1 no longer raises but runs its spill branch, and the
    service answers as the plain version does."""
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 6, 6), 4096
    corpus = cp_random_data(gen, dims, 3, batch=n)
    svc = build_service(gen, "cp-srp", dims, corpus, num_codes=2,
                        num_tables=8, rank=2, bucket_cap=2048)
    q = _planted(gen, corpus, n, 16)
    spills = fused_query.branches["spill"]
    nc = _k1_vs_plain(svc, q, 2)
    assert fused_query.branches["spill"] == spills + 1
    assert int(nc.max()) > 1000
    ids, _, n_cand = svc.query_arrays(q, probes=2)
    assert (n_cand == nc.cpu().numpy()).all() and (ids[:, 0] >= 0).all()


def _spilled(monkeypatch, fn):
    """``fn()`` with K1's window plan sending every window to the spill
    branch -> (its result, the spill launches it added)."""
    spills = fused_query.branches["spill"] + fused_query_sharded.branches[
        "spill"]
    plan = fq_mod.window_plan
    with monkeypatch.context() as m:
        m.setattr(fq_mod, "window_plan",
                  lambda *a, **k: (plan(*a, **k)[0], "spill"))
        out = fn()
        torch.cuda.synchronize()
    return out, (fused_query.branches["spill"]
                 + fused_query_sharded.branches["spill"] - spills)


@pytest.mark.parametrize("layout,shards", [("cp", 1), ("tt", 1), ("cp", 3),
                                           ("tt", 3)])
def test_fused_query_spill_equals_shared(gen, monkeypatch, layout, shards):
    """Where both branches can run, the spill branch's ids, scores and
    candidate counts equal the shared branch's bit for bit: K1 and K1s, CP
    and TT, a base and two deltas, deletes, live windows, T = 1 and 4."""
    from repro_torch.serving.lsh_service import build_service
    n = 12000
    data = cp_random_data if layout == "cp" else tt_random_data
    dims = (6, 6, 6) if layout == "cp" else (8, 8, 8)
    w = 2.0 if layout == "cp" else 8.0
    corpus = data(gen, dims, 3, batch=n)
    svc = build_service(gen, f"{layout}-e2lsh", dims, corpus, num_codes=6,
                        num_tables=4, rank=2, bucket_width=w, bucket_cap=24,
                        shards=shards if shards > 1 else None)
    for _ in range(2):
        svc.insert(data(gen, dims, 3, batch=500))
    svc.delete(torch.arange(0, svc.index.size, 9, device="cuda"))
    q = _planted(gen, corpus, n, 200)
    shared = fused_query.branches["shared"] + fused_query_sharded.branches[
        "shared"]
    for probes in (1, 4):
        want = svc.query_arrays(q, probes=probes)
        got, spills = _spilled(monkeypatch,
                               lambda: svc.query_arrays(q, probes=probes))
        assert spills == 1
        for g, w_ in zip(got, want):
            assert (g.view("int32") == w_.view("int32")).all()
    assert fused_query.branches["shared"] + fused_query_sharded.branches[
        "shared"] == shared + 2
    check = _k1s_vs_plain if shards > 1 else _k1_vs_plain
    _, spills = _spilled(monkeypatch, lambda: check(svc, q, 4))
    assert spills == 1


def test_srp_pack_matches_plain(gen):
    """K6 bit for bit against its plain version: benchmarks/kernels.py's
    (256, 256), the ragged shapes of tests/test_kernels.py, a serving-scale
    batch, exact and negative zeros."""
    shapes = [(256, 256), (1, 1), (3, 31), (5, 33), (7, 40), (8, 70),
              (13, 64), (20, 5), (9, 96), (1 << 16, 128)]
    for b, k in shapes:
        v = torch.randn((b, k), generator=gen, device="cuda")
        v[:, ::5] = 0.0
        v[:, 1::7] = -0.0
        launches = srp_pack.launches
        got = ops.srp_pack(v)
        want = srp_pack_plain(v)
        torch.cuda.synchronize()
        assert srp_pack.launches == launches + 1
        assert got.shape == (b, -(-k // 32)) and torch.equal(got, want)


@pytest.mark.parametrize("w", [4.0, 6.0])
def test_e2lsh_quant_matches_plain(gen, w):
    """K7 bit for bit against its plain version (both divide by w): random
    values, ragged K, and values one ulp below a bucket edge."""
    for b, k in ((256, 100), (7, 1), (33, 129), (1 << 16, 100)):
        v = 10.0 * torch.randn((b, k), generator=gen, device="cuda")
        offs = torch.rand(k, generator=gen, device="cuda") * w
        m = torch.randint(-1000, 1000, (b, k), generator=gen, device="cuda")
        edge = torch.nextafter(m.float() * w, torch.tensor(
            -float("inf"), device="cuda")) - offs
        for vals in (v, edge):
            launches = e2lsh_quant.launches
            got = ops.e2lsh_quantize(vals, offs, w)
            want = e2lsh_quant_plain(vals, offs, w)
            torch.cuda.synchronize()
            assert e2lsh_quant.launches == launches + 1
            assert got.dtype == torch.int32 and torch.equal(got, want)


def _k1s_vs_plain(svc, q, probes):
    """K1s against its plain version over every (shard, segment) pair of
    the service's sharded store, on the same raw values -> the kernel's
    candidate counts."""
    idx = svc.index
    fam, view = idx.family, idx.store.view
    qs = q.stack()
    values = fam.raw_stacked(qs[1], q.scale)
    args = (values, fam.offsets, idx._mults_t, qs, view.seg_arrays(0),
            view.delta_arrays)
    kw = dict(kind=fam.kind, w=fam.bucket_width, num_tables=fam.num_tables,
              num_codes=fam.num_codes, metric=idx.metric, topk=10,
              cap=view.base.cap, delta_caps=view.delta_caps, probes=probes)
    launches = fused_query_sharded.launches
    ids, sc, nc = fused_query_sharded(*args, table=view.k1_table, **kw)
    ids_p, sc_p, nc_p = fused_query_sharded_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fused_query_sharded.launches == launches + 1
    assert torch.equal(nc, nc_p)
    tol = parity.rerank_bound(idx.metric, q, idx.effective_corpus(), ids_p,
                              sc_p)
    same = (ids == ids_p) & (ids_p >= 0)
    assert bool(((sc - sc_p).abs()[same] <= tol[same]).all())
    assert parity.topk_mismatches(ids, sc, ids_p, sc_p, tol) == 0
    assert bool((ids < idx.size).all())
    return nc


@pytest.mark.parametrize("layout", ["cp", "tt"])
def test_fused_query_sharded_matches_plain(gen, layout):
    """S = 3 over 20,000 items (the last shard padded), two routed slabs,
    deletes in the base and the slabs, live windows, T = 1 and 4."""
    from repro_torch.serving.lsh_service import build_service
    n = 20000
    data = cp_random_data if layout == "cp" else tt_random_data
    dims = (6, 6, 6) if layout == "cp" else (8, 8, 8)
    w = 2.0 if layout == "cp" else 8.0
    corpus = data(gen, dims, 3, batch=n)
    svc = build_service(gen, f"{layout}-e2lsh", dims, corpus, num_codes=6,
                        num_tables=4, rank=2, bucket_width=w, bucket_cap=16,
                        shards=3, probes=4)
    base = svc.index.store.base
    assert base.counts == (6667, 6667, 6666) and base.shard_size == 6667
    inserted = [data(gen, dims, 3, batch=700) for _ in range(2)]
    for batch in inserted:
        svc.insert(batch)
    svc.delete(torch.arange(0, svc.index.size, 5, device="cuda"))
    occ = svc.stats.shard_occupancy
    assert len(svc.index.store.deltas) == 2 and sum(occ) == svc.index.size
    q = _planted(gen, inserted[1], 700, 200)
    for probes in (1, 4):
        nc = _k1s_vs_plain(svc, q, probes)
        assert int(nc.sum()) > 0
    for branch in ("multiprobe", "live_window", "segments"):
        assert fused_query_sharded.branches[branch] > 0


@pytest.mark.parametrize("layout", ["cp", "tt"])
def test_fused_query_sharded_equals_single_device(gen, layout):
    """Exact cap: the sharded index (a padded last shard, a routed slab, a
    delete) answers like the single-device index over the same items, ids,
    scores and candidate counts bit for bit: K1 scores a candidate from its
    row and the query alone, whatever (shard, segment) holds it."""
    from repro_torch.serving.lsh_service import build_service
    n = 12001
    data = cp_random_data if layout == "cp" else tt_random_data
    dims = (6, 6, 6) if layout == "cp" else (8, 8, 8)
    kind = f"{layout}-e2lsh"
    w = 2.0 if layout == "cp" else 8.0
    corpus = data(gen, dims, 3, batch=n)
    kw = dict(num_codes=8, num_tables=4, rank=2, bucket_width=w)
    single = build_service(gen, kind, dims, corpus, **kw)
    sharded = build_service(None, kind, dims, corpus, shards=3,
                            family=single.index.family, **kw)
    batch = data(gen, dims, 3, batch=300)
    for svc in (single, sharded):
        svc.insert(batch)
        svc.delete(torch.arange(7, n, 11, device="cuda"))
    q = _planted(gen, corpus, n, 256)
    for probes in (1, 3):
        got = sharded.query_arrays(q, probes=probes)
        want = single.query_arrays(q, probes=probes)
        for g, w_ in zip(got, want):
            assert (g.view("int32") == w_.view("int32")).all()
    _k1s_vs_plain(sharded, q, 3)
