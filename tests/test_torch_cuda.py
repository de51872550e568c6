"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA card and ``nvcc`` (the kernels build
at first use for sm_90a) and skip elsewhere, deciding inside a fixture.
Run them on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

K3 (``cp_gram``) and K4 (``tt_inner``) at a 1,024-item query launch of the
serving shapes, in every thread-kernel instantiation, at the ranks of
benchmarks/kernels.py (32 and 16: the warp kernels) and at K = 2000 / 1024
hashes in one table (cut over hash blocks): raw values within
``parity.raw_bound`` / ``parity.tt_raw_bound``; codes, keys and packed
words equal except where a value lies within that bound of a bucket edge
(E2LSH) or of 0 (SRP). K1 (``fused_query``, CP and TT re-rank): on the same
raw values and segment arrays, candidate counts equal bit for bit, scores
within ``parity.rerank_bound``, ids equal except at near ties; so also on
its multi-probe (T = 8, dense window), live-window (``bucket_cap``, after
deletes) and multi-segment (a base and eight deltas) branches, at TT
rank 16, and with windows past the shared hash set (the global scratch:
one batch mixing queries that fit and queries that overflow, on integer
data whose scores are exact, equal to the plain version bit for bit, K1
and K1s, CP and TT; equal scores break by effective id). K6 (``srp_pack``) and K7 (``e2lsh_quant``)
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
from repro_torch.core.tensor_formats import (CPTensor, TTTensor,
                                             cp_random_data, tt_random_data)
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
    ((12, 12, 12), 1024, 10, 10, 4, 3),   # a query batch's launch: <4, 3>
    ((12, 12, 12), 200, 3, 5, 4, 4),      # <4, 4>, float4 rows both sides
    ((5, 5, 5), 50, 3, 4, 6, 8),          # ranks above 4: <8, 8>
    ((6, 6, 6), 33, 3, 7, 12, 5),         # the warp kernel, tables cut
    ((512,) * 4, 24, 1, 8, 8, 8),         # rows no thread block stages: warp
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
    ((16, 16, 16, 16), 1024, 10, 10, 4, 4),  # a query batch's launch
    ((9,), 40, 2, 5, 2, 2),                  # N = 1: mode 0 only
    ((5, 5), 40, 2, 5, 6, 8),                # R = 8 at N = 2
    ((6, 6), 33, 3, 7, 12, 3),               # the warp kernel, N = 2, cut
    ((64, 64, 64), 20, 2, 8, 8, 8),          # R = 8, slice chunks of 8
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


def _scratch_queries():
    """Queries that took K1's (and K1s's) global scratch so far."""
    return (fused_query.branches["scratch"]
            + fused_query_sharded.branches["scratch"])


def test_fused_query_window_limit_raises(gen):
    """One segment's L*T*cap beyond the shared window (8 * 2 * 2048 = 32768
    slots, windows of thousands): K1 does not raise but dedups those
    queries' windows in its global scratch, and the service answers as the
    plain version does."""
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 6, 6), 4096
    corpus = cp_random_data(gen, dims, 3, batch=n)
    svc = build_service(gen, "cp-srp", dims, corpus, num_codes=2,
                        num_tables=8, rank=2, bucket_cap=2048)
    q = _planted(gen, corpus, n, 16)
    before = _scratch_queries()
    nc = _k1_vs_plain(svc, q, 2)
    assert _scratch_queries() > before
    assert int(nc.max()) > 1000
    ids, _, n_cand = svc.query_arrays(q, probes=2)
    assert (n_cand == nc.cpu().numpy()).all() and (ids[:, 0] >= 0).all()


def _integer_data(gen, layout, dims, n):
    """n CP (rank 3) or TT (rank 2) items with entries in {-1, 0, 1}: their
    inner products are small integers, exact in float32 in any order, so
    K1's scores equal the plain version's bit for bit and equal distances
    are exact ties."""
    if layout == "cp":
        return CPTensor(tuple(
            torch.randint(-1, 2, (n, d, 3), generator=gen,
                          device="cuda").float() for d in dims), 1.0)
    shapes = [(1 if i == 0 else 2, d, 1 if i == len(dims) - 1 else 2)
              for i, d in enumerate(dims)]
    return TTTensor(tuple(
        torch.randint(-1, 2, (n, *s), generator=gen, device="cuda").float()
        for s in shapes), 1.0)


def _repeat(x, idx):
    """Items ``idx`` of ``x`` (a 1-D index tensor, repeats allowed)."""
    return type(x)(tuple(f[idx] for f in x.leaves), x.scale)


def _bitwise_vs_plain(svc, q, probes, topk=10):
    """K1 (K1s on a sharded store) against its plain version on the same raw
    values: ids, scores and candidate counts equal bit for bit."""
    idx = svc.index
    fam, view = idx.family, idx.store.view
    qs = q.stack()
    values = fam.raw_stacked(qs[1], q.scale)
    kw = dict(kind=fam.kind, w=fam.bucket_width, num_tables=fam.num_tables,
              num_codes=fam.num_codes, metric=idx.metric, topk=topk,
              probes=probes)
    if view.sharded:
        args = (view.seg_arrays(0), view.delta_arrays)
        kw.update(cap=view.base.cap, delta_caps=view.delta_caps)
        kernel, plain = fused_query_sharded, fused_query_sharded_plain
    else:
        args, kw["caps"] = (view.all_arrays,), view.all_caps
        kernel, plain = fused_query, fused_query_plain
    got = kernel(values, fam.offsets, idx._mults_t, qs, *args,
                 table=view.k1_table, **kw)
    want = plain(values, fam.offsets, idx._mults_t, qs, *args, **kw)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert torch.equal(g.view(torch.int32), w_.view(torch.int32))
    return got


@pytest.mark.parametrize("layout,shards", [("cp", 1), ("tt", 1), ("cp", 3),
                                           ("tt", 3)])
def test_fused_query_spill_equals_shared(gen, layout, shards):
    """One batch mixes queries whose window fits the shared hash set with
    queries whose window overflows it into the global scratch: one item is
    repeated (its bucket fills every table's window, past the largest
    shared window in every shard), in the base and in two deltas, with
    deletes. Every query's ids, scores and candidate count equal the plain
    version's bit for bit, K1 and K1s, CP and TT, T = 1 and 4; the repeats
    tie at distance 0, so their order is the effective ids'. The launches
    share the view's scratch at row strides that change with T and at
    smaller batches after larger ones."""
    from repro_torch.serving.lsh_service import build_service
    dims = (6, 6, 6) if layout == "cp" else (8, 8, 8)
    n, dup = 6000, 3 * shards * fq_mod.MAX_WINDOW // 4
    base = _integer_data(gen, layout, dims, n)
    rows = torch.cat([torch.arange(n, device="cuda"),
                      torch.zeros(dup, dtype=torch.long, device="cuda")])
    corpus = _repeat(base, rows[torch.randperm(n + dup, generator=gen,
                                               device="cuda")])
    svc = build_service(gen, f"{layout}-e2lsh", dims, corpus, num_codes=6,
                        num_tables=4, rank=2, bucket_width=4.0,
                        shards=shards if shards > 1 else None)
    for _ in range(2):
        more = _integer_data(gen, layout, dims, 300)
        copies = _repeat(base, torch.zeros(200, dtype=torch.long,
                                           device="cuda"))
        svc.insert(type(base)(tuple(torch.cat(pair) for pair in zip(
            more.leaves, copies.leaves)), 1.0))
    svc.delete(torch.arange(0, svc.index.size, 9, device="cuda"))
    q = _repeat(base, torch.cat([
        torch.zeros(64, dtype=torch.long, device="cuda"),
        torch.randint(1, n, (192,), generator=gen, device="cuda")]))
    for probes, b in ((1, 256), (4, 256), (1, 256), (4, 96), (1, 80)):
        before = _scratch_queries()
        ids, sc, nc = _bitwise_vs_plain(
            svc, _repeat(q, torch.arange(b, device="cuda")), probes)
        took = _scratch_queries() - before
        assert 64 <= took < b
        assert bool((sc[:64] == 0).all()) and bool(
            (ids[:64, 1:] > ids[:64, :-1]).all())


@pytest.mark.parametrize("layout", ["cp", "tt"])
def test_fused_query_ties_break_by_effective_id(gen, layout):
    """Equal scores: 40 copies of each of a few items, spread over the
    corpus, so that the warps' lists each hold some of a query's tied
    candidates; the merged top-k is the k smallest effective ids among the
    copies, as in the plain version, for k = 10 and for k = 48 (lists
    longer than a warp)."""
    from repro_torch.serving.lsh_service import build_service
    dims = (6, 6, 6) if layout == "cp" else (8, 8, 8)
    base = _integer_data(gen, layout, dims, 2000)
    rows = torch.cat([torch.arange(2000, device="cuda"),
                      torch.arange(5, device="cuda").repeat(40)])
    perm = torch.randperm(len(rows), generator=gen, device="cuda")
    corpus = _repeat(base, rows[perm])
    svc = build_service(gen, f"{layout}-e2lsh", dims, corpus, num_codes=6,
                        num_tables=4, rank=2, bucket_width=4.0)
    q = _repeat(base, torch.arange(5, device="cuda"))
    for topk in (10, 48):
        ids, sc, _ = _bitwise_vs_plain(svc, q, 1, topk=topk)
        for i in range(5):
            copies = torch.nonzero(rows[perm] == i).flatten()
            k = min(topk, len(copies))
            assert torch.equal(ids[i, :k].long(), copies[:k])
            assert bool((sc[i, :k] == 0).all())


def _k6_values(gen, b, k, offset=0, dtype=torch.float32):
    """(b, k) N(0, 1) values with exact and negative zeros, NaN and +-inf
    sprinkled in; ``offset`` floats into a buffer (a contiguous view whose
    address is not 16-byte aligned where offset % 4 != 0)."""
    buf = torch.randn(b * k + offset, generator=gen, device="cuda")
    v = buf[offset:].view(b, k)
    v[:, ::5] = 0.0
    v[:, 1::7] = -0.0
    v[:, 2::11] = float("nan")
    v[:, 3::13] = float("inf")
    v[:, 4::17] = -float("inf")
    return v.to(dtype)


# (B, K, storage offset in floats, dtype): benchmarks/kernels.py's
# (256, 256), the ragged shapes of tests/test_kernels.py, K in {4, 100,
# 2000, 4096} (4096: rows cut into pieces), B not a multiple of a chunk's
# rows, B past the grid (the grid-stride loop wraps), views with a storage
# offset (the scalar path at K % 4 == 0), float16
K6_CASES = {
    "ragged": [(256, 256), (1, 1), (3, 31), (5, 33), (7, 40), (8, 70),
               (13, 64), (20, 5), (9, 96)],
    "k": [(1000, 4), (3000, 100), (257, 2000), (33, 4096), (4099, 8)],
    "rows": [(100003, 32), (70001, 100)],
    "wraps": [(1 << 17, 128), (1 << 16, 2000), (4000, 4096)],
    "offset": [(256, 128, 1), (129, 100, 2), (17, 2000, 3), (5, 4096, 1),
               (100003, 32, 2)],
    "float16": [(300, 100, 0, torch.float16), (77, 33, 0, torch.float16)],
}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_srp_pack_matches_plain(gen, case):
    """K6 bit for bit against its plain version (exact and negative zeros,
    NaN and +-inf included), one launch a call, on the path its plan
    names; ``rows`` cases end on a partial chunk, ``wraps`` cases have more
    chunks than the grid has warps."""
    from repro_torch.kernels.epilogues import sm_count
    from repro_torch.kernels.srp_pack import WARPS, plan
    for b, k, *rest in K6_CASES[case]:
        offset = rest[0] if rest else 0
        dtype = rest[1] if len(rest) > 1 else torch.float32
        v = _k6_values(gen, b, k, offset, dtype)
        # the wrapper's float32 copy of a float16 input is a fresh, aligned
        # allocation
        aligned = dtype != torch.float32 or v.data_ptr() % 16 == 0
        p = plan(b, k, sm_count(v.device), aligned)
        if case == "offset":
            assert p.path == "scalar"
        if case == "rows":
            assert p.rows > 1 and b % p.rows != 0
        if case == "wraps":
            assert p.chunks > p.blocks * WARPS
        launches = srp_pack.launches
        got = ops.srp_pack(v)
        want = srp_pack_plain(v)
        torch.cuda.synchronize()
        assert srp_pack.launches == launches + 1
        assert got.shape == (b, -(-k // 32)), (b, k, offset)
        assert torch.equal(got, want), (b, k, offset, dtype, p)


def test_srp_pack_launch_refuses_another_plan(gen):
    """The C launch recomputes K6's plan from the shape, the card and the
    pointer, and refuses one that differs (a float4 path on a misaligned
    view, another grid) with cudaErrorInvalidConfiguration."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.epilogues import sm_count
    from repro_torch.kernels.srp_pack import plan
    v = _k6_values(gen, 4096, 128, offset=1)
    out = torch.empty((4096, 4), dtype=torch.int64, device="cuda")
    p = plan(4096, 128, sm_count(v.device), False)
    stream = torch.cuda.current_stream().cuda_stream
    for path, blocks in ((1, p.blocks), (0, p.blocks + 1)):
        err = _build.lib().srp_pack_launch(
            v.data_ptr(), out.data_ptr(), 4096, 128, p.threads, blocks,
            p.rows, p.pieces, path, stream)
        assert err == 9          # cudaErrorInvalidConfiguration
    assert _build.lib().srp_pack_launch(
        v.data_ptr(), out.data_ptr(), 4096, 128, p.threads, p.blocks, p.rows,
        p.pieces, 0, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, srp_pack_plain(v))


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
