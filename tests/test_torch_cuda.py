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
the exact cap its answers equal the single-device index's bit for bit. K1
and K1s on dense rows of 64, 1,728, 1,730 (the scalar path) and 65,536
floats against their plain versions, with self-queries; the naive and
tensorized kinds over a mutated, capped dense store at T = 4 bit for bit
on integer rows; the C launch refusing a dense plan of another shape or
shared size; the dense re-rank at its ring's edges (rows in the ring
slots or read in place, one candidate or none a query) bit for bit on
integer rows; dense queries over CP rows at the sweep's edges (rank
chunks, one mode and ten, CP rank 1 and 32). K1's
six cross-format pairs (a query batch in another format than the corpus's:
dense x CP, CP x dense, dense x TT, TT x dense, CP x TT, TT x CP) against
their plain versions at T = 1 and, with a live window over two segments,
T = 4; CP and TT queries densified past the staged row (65,536 floats, the
global scratch) and a dense query of that length read in place; K1s with
mixed queries at S = 3, equal to the single-device index bit for bit.
CP and dense queries over TT rows of ranks at most 4 (two rows a warp) at
TT ranks 1 to 4, ragged, three and four modes, T = 1 and a live window at
T = 4, a heavy query through the global scratch (bit for bit on integer
data), K1s at S = 3; TT ranks 5 to 16 beside them: TT queries of ranks 5
to 16 over CP rows (``<0, 16>``) at CP row ranks 1 to 6 and 32, a live
window, the global scratch and K1s; dense queries over TT rows of ranks
5 to 16 (``<16, kDense>``) through the ring slots or in place, rows of
whole floats, a query row past the staged one, K1s; CP and TT queries
over TT rows of ranks 5 to 16 (``<16, 0>``, ``<8, 8>``, ``<16, 16>``: a
row a warp through a ring slot or in place, ``tt_chain``) at ranks 5, 8
and 16, ragged, four modes, a live window at T = 4, the global scratch
bit for bit on integer data, and K1s. The serving scheduler's streams:
the query lane on its own stream of the highest priority, the ingest lane
on another, neither the default stream, each lane's kernels counted on it;
a view published on one stream behind a delay kernel read on another
right after the flip (its event waited on; the control without the wait
reads the unfinished table); K1's global scratch per stream (two threads,
two streams, one view); the chunked fold bit-equal to the one-pass fold.
Durability: a durable insert of a batch on the card logs the bytes of the
same batch from the host; recovery on the card (snapshot upload, WAL
replay) answers bit for bit as the live service at S = None and S = 2
through K1 and K1s, with no plain version run; a recovery on the
scheduler's ingest lane runs on the ingest stream and the next query-lane
read answers from the restored view, not the old one. ``brute_force`` of
one query equals its ``brute_force_batch`` row bit for bit on the card.
"""

import math

import pytest
import torch

from repro_torch.core.projections import (sample_cp_projection,
                                          sample_tt_projection)
from repro_torch.core.tensor_formats import (CPTensor, TTTensor, as_batch,
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


def _dense_service(gen, dims, n, kind="e2lsh", shards=None, **kw):
    """A dense Gaussian corpus of n items and its service: K = L = 4, w
    about the projections' spread (sqrt(prod d))."""
    from repro_torch.serving.lsh_service import build_service
    corpus = torch.randn((n,) + dims, generator=gen, device="cuda")
    w = float(torch.tensor(dims).prod()) ** 0.5
    svc = build_service(gen, kind, dims, corpus, num_codes=4, num_tables=4,
                        rank=2, bucket_width=w, shards=shards, **kw)
    return corpus, svc


@pytest.mark.parametrize("dims,n,shards", [
    ((4, 4, 4), 3000, None),          # 64 floats: the query row staged
    ((12, 12, 12), 4000, None),       # [dense-main]'s rows, float4 loads
    ((10, 173), 3000, None),          # 1,730 floats: the scalar path
    ((16, 16, 16, 16), 1500, None),   # 65,536 floats: the query read in place
    ((12, 12, 12), 4001, 3),          # K1s: a padded last shard
    ((10, 173), 3001, 3),             # K1s, the scalar path
])
def test_fused_query_dense_matches_plain(gen, dims, n, shards):
    """K1 (K1s on a sharded store) on dense rows against its plain version
    on the same raw values: candidate counts equal, scores within
    ``parity.rerank_bound`` (2 (prod d + 4) u sum |q||y| carried through
    the score), ids equal but at near ties; and an item queried as itself
    comes back first."""
    from repro_torch.kernels.fused_query import DENSE, SHAPES, occupancy
    corpus, svc = _dense_service(gen, dims, n, shards=shards)
    idx = svc.index
    qid = torch.randint(0, n, (300,), generator=gen, device="cuda")
    q = corpus[qid] + 0.05 * torch.randn((300,) + dims, generator=gen,
                                         device="cuda")
    fam, view = idx.family, idx.store.view
    qd = as_batch(q).stack()
    values = fam.raw_stacked(qd[1], 1.0)
    kw = dict(kind=fam.kind, w=fam.bucket_width, num_tables=4, num_codes=4,
              metric="euclidean", topk=10)
    if view.sharded:
        args = (view.seg_arrays(0), view.delta_arrays)
        kw.update(cap=view.base.cap, delta_caps=view.delta_caps)
        kernel, plain = fused_query_sharded, fused_query_sharded_plain
    else:
        args, kw["caps"] = (view.all_arrays,), view.all_caps
        kernel, plain = fused_query, fused_query_plain
    launches = kernel.launches
    ids, sc, nc = kernel(values, fam.offsets, idx._mults_t, qd, *args,
                         table=view.k1_table, **kw)
    ids_p, sc_p, nc_p = plain(values, fam.offsets, idx._mults_t, qd, *args,
                              **kw)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    assert torch.equal(nc, nc_p) and int(nc.sum()) > 0
    tol = parity.rerank_bound("euclidean", qd[0], idx.effective_corpus(),
                              ids_p, sc_p)
    same = (ids == ids_p) & (ids_p >= 0)
    assert bool(((sc - sc_p).abs()[same] <= tol[same]).all())
    assert parity.topk_mismatches(ids, sc, ids_p, sc_p, tol) == 0
    self_ids, self_sc, _ = idx.query_batch(corpus[qid[:64]], topk=1)
    assert torch.equal(self_ids[:, 0].long(), qid[:64])
    _, _, smem = fq_mod.launch_plan(view.k1_table, 1, num_tables=4,
                                    probes=1, topk=10, expansion=0)
    occ = occupancy(view.k1_table, 1, smem)
    target = SHAPES[DENSE, DENSE][1]
    assert occ["blocks_per_sm"] >= target == occ["target_blocks"]


@pytest.mark.parametrize("kind", ["srp", "cp-e2lsh", "tt-srp"])
def test_fused_query_dense_kinds_after_mutations(gen, kind):
    """The other kinds over a dense corpus, capped (live windows), T = 4,
    after deletes and an insert (two segments): K1's dense branch against
    its plain version bit for bit on integer-valued rows (exact sums in any
    order)."""
    dims, n = (6, 6, 6), 3000
    from repro_torch.serving.lsh_service import build_service
    corpus = torch.randint(-1, 2, (n,) + dims, generator=gen,
                           device="cuda").float()
    svc = build_service(gen, kind, dims, corpus, num_codes=4, num_tables=4,
                        rank=2, bucket_width=8.0, bucket_cap=16, probes=4)
    svc.delete(list(range(0, n, 7)))
    svc.insert(corpus[:200])
    q = corpus[torch.randint(0, n, (200,), generator=gen, device="cuda")]
    _bitwise_vs_plain(svc, as_batch(q), 4)


def test_fused_query_dense_launch_refuses_another_plan(gen, monkeypatch):
    """The C launch recomputes the dense instantiation's threads, blocks
    per SM and shared bytes, with its rows' ring or without it, and refuses
    a plan made with others (the first design's 8 warps and 3 blocks, a
    ring slot of another size); a plan without the ring (rows read in
    place) is taken and answers alike; rows past ``MAX_DENSE_ROW`` floats
    raise by name."""
    corpus, svc = _dense_service(gen, (12, 12, 12), 2000)
    q = corpus[:64]
    want = svc.index.query_batch(q)
    key = (fq_mod.DENSE, fq_mod.DENSE)
    shape = fq_mod.SHAPES[key]
    for other in ((256, 3, 2, 2), (256, 2, 2, 2), (384, 3, 2, 2)):
        monkeypatch.setitem(fq_mod.SHAPES, key, other)
        with pytest.raises(RuntimeError, match="fused_query_launch"):
            svc.index.query_batch(q)
    monkeypatch.setitem(fq_mod.SHAPES, key, shape)
    monkeypatch.setattr(fq_mod, "ring_slot", lambda d: d + 4)
    fq_mod._plan.cache_clear()
    with pytest.raises(RuntimeError, match="fused_query_launch"):
        svc.index.query_batch(q)
    monkeypatch.undo()
    monkeypatch.setattr(fq_mod, "RING_ROW", 1024)
    fq_mod._plan.cache_clear()
    assert not fq_mod.ring_plan(4, svc.index.cap, 1728)
    for g, w_ in zip(svc.index.query_batch(q), want):
        assert torch.equal(g.view(torch.int32), w_.view(torch.int32))
    monkeypatch.undo()
    fq_mod._plan.cache_clear()
    monkeypatch.setattr(fq_mod, "MAX_DENSE_ROW", 1000)
    with pytest.raises(ValueError, match="MAX_DENSE_ROW"):
        svc.index.query_batch(q)


@pytest.mark.parametrize("dims,cap,tables,kind", [
    ((12, 12, 12), None, 4, "e2lsh"),  # ring slots; counts not a multiple of 12
    ((12, 12, 12), 1, 1, "e2lsh"),     # one candidate a query, or none
    ((4, 4, 4), 16, 4, "srp"),         # 64-float slots, live windows
    ((2, 1032), None, 4, "e2lsh"),     # 2,064 floats: past the ring slot
    ((6, 173), None, 4, "e2lsh"),      # 1,038 floats: whole floats, in place
])
def test_fused_query_dense_ring_edges(gen, dims, cap, tables, kind):
    """K1's dense re-rank at the ring's edges against its plain version bit
    for bit on integer-valued rows (exact sums in any order): rows copied
    into the warps' ring slots or read in place, candidate lists of any
    length, of one entry and empty (queries far from every item)."""
    from repro_torch.serving.lsh_service import build_service
    n = 3000
    corpus = torch.randint(-1, 2, (n,) + dims, generator=gen,
                           device="cuda").float()
    w = float(torch.tensor(dims).prod()) ** 0.5
    svc = build_service(gen, kind, dims, corpus, num_codes=4,
                        num_tables=tables, bucket_width=w, bucket_cap=cap)
    near = corpus[torch.randint(0, n, (200,), generator=gen, device="cuda")]
    far = torch.randint(-1, 2, (56,) + dims, generator=gen,
                        device="cuda").float() * 1000.0
    _, _, nc = _bitwise_vs_plain(svc, as_batch(torch.cat([near, far])), 1)
    assert int(nc.sum()) > 0
    if kind == "e2lsh":
        assert int(nc.min()) == 0
    if cap == 1:
        assert set(nc.tolist()) == {0, 1}


@pytest.mark.parametrize("dims,rank,cap,tables", [
    ((12, 12, 12), 4, None, 4),  # [main]'s widths: float4 ranks
    ((13, 3, 2), 1, None, 4),    # d_1 = 13, past the unroll of 4; rank 1
    ((6, 5, 7), 32, None, 4),    # the largest CP rank K3 hashes: 8 chunks
    ((40,), 3, None, 4),         # one mode: one column, no table
    ((2,) * 10, 5, None, 4),     # ten modes; a ragged rank chunk
    ((12, 12, 12), 4, 1, 1),     # one candidate a query, or none
])
def test_fused_query_dense_x_cp_sweep_edges(gen, dims, rank, cap, tables):
    """Dense queries over CP rows (``dense_cp_sweep``, two rows a warp)
    against K1's plain version at the sweep's edges: rank chunks, one mode,
    ten, the column table, one candidate and none (a warp's second row
    empty; queries far from every item);
    candidate counts equal, scores within ``parity.rerank_bound``, ids
    equal but at near ties."""
    from repro_torch.core.tensor_formats import DenseTensor
    from repro_torch.serving.lsh_service import build_service
    n = 3000
    corpus = cp_random_data(gen, dims, rank, batch=n)
    svc = build_service(gen, "cp-e2lsh", dims, corpus, num_codes=4,
                        num_tables=tables, rank=2, bucket_width=2.0,
                        bucket_cap=cap)
    near = _as_layout(_planted(gen, corpus, n, 200), "dense").data
    far = 1000.0 * torch.randn((56,) + dims, generator=gen, device="cuda")
    q = DenseTensor(torch.cat([near, far]), dims)
    before = fused_query.branches["mixed:dense-cp"]
    nc = _k1_vs_plain(svc, q, 1)
    assert fused_query.branches["mixed:dense-cp"] == before + 1
    assert int(nc.sum()) > 0
    if cap == 1:
        assert set(nc.tolist()) == {0, 1}


MIXED = list(fq_mod.MIXED_PAIRS)
# the family that indexes each corpus layout in the cross-format tests: the
# paper's TT-E2LSH on CP inputs and CP-E2LSH on TT inputs
MIXED_KIND = {"cp": "tt-e2lsh", "tt": "cp-e2lsh", "dense": "cp-e2lsh"}


def _as_layout(x, layout):
    """A CP batch as ``layout``, exactly: itself, its TT copy (diagonal
    cores) or its dense rows."""
    from repro_torch.core.projections import densify_batch
    from repro_torch.core.tensor_formats import DenseTensor, cp_to_tt
    if layout == "cp":
        return x
    if layout == "tt":
        return cp_to_tt(x)
    return DenseTensor(densify_batch(x).reshape((-1,) + x.dims), x.dims)


def _mixed_service(gen, dims, n, cf, shards=None, **kw):
    """CP data of rank 3 held as ``cf`` and its service (K = L = 4, w = 2,
    the kind of ``MIXED_KIND``) -> (the CP corpus, the service)."""
    from repro_torch.serving.lsh_service import build_service
    corpus = cp_random_data(gen, dims, 3, batch=n)
    svc = build_service(gen, MIXED_KIND[cf], dims, _as_layout(corpus, cf),
                        num_codes=4, num_tables=4, rank=2, bucket_width=2.0,
                        shards=shards, **kw)
    return corpus, svc


@pytest.mark.parametrize("qf,cf", MIXED)
@pytest.mark.parametrize("probes,cap", [(1, None), (4, 16)])
def test_fused_query_mixed_matches_plain(gen, qf, cf, probes, cap):
    """K1's cross-format branch for each (query, corpus) pair against its
    plain version on the same raw values: the exact cap at T = 1, and a
    live window (``bucket_cap``) after deletes and an insert (two segments)
    at T = 4. Candidate counts equal, scores within ``parity.rerank_bound``'s
    cross terms, ids equal but at near ties; the launch counted under its
    pair, and the planted neighbour found."""
    dims, n = (6, 5, 7), 3000
    corpus, svc = _mixed_service(gen, dims, n, cf, bucket_cap=cap,
                                 probes=probes)
    if cap is not None:
        svc.delete(list(range(1, n, 9)))
        svc.insert(_as_layout(cp_random_data(gen, dims, 3, batch=200), cf))
    q = _planted(gen, corpus, n, 256)
    name = f"mixed:{qf}-{cf}"
    before = fused_query.branches[name]
    nc = _k1_vs_plain(svc, _as_layout(q, qf), probes)
    assert fused_query.branches[name] == before + 1 and int(nc.sum()) > 0


@pytest.mark.parametrize("qf,cf", [("cp", "dense"), ("tt", "dense"),
                                   ("dense", "tt")])
def test_fused_query_mixed_past_the_staged_row(gen, qf, cf):
    """(16, 16, 16, 16): a CP or TT query's densified row (65,536 floats)
    goes to the global scratch instead of shared memory, and a dense query
    of that length is read in place; K1 against its plain version."""
    dims, n = (16, 16, 16, 16), 1500
    corpus, svc = _mixed_service(gen, dims, n, cf)
    q = _planted(gen, corpus, n, 64)
    _k1_vs_plain(svc, _as_layout(q, qf), 1)


@pytest.mark.parametrize("qf,cf", [("dense", "cp"), ("tt", "cp"),
                                   ("cp", "tt"), ("tt", "dense"),
                                   ("dense", "tt")])
def test_fused_query_sharded_mixed_matches_plain(gen, qf, cf):
    """K1s with a query batch of another format, S = 3 (a padded last
    shard), after deletes and a routed insert, at T = 1 and 4; and its
    answers equal the single-device index's bit for bit."""
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 5, 7), 3001
    corpus, single = _mixed_service(gen, dims, n, cf)
    sharded = build_service(None, MIXED_KIND[cf], dims, _as_layout(corpus, cf),
                            shards=3, family=single.index.family,
                            num_codes=4, num_tables=4, bucket_width=2.0)
    q = _as_layout(_planted(gen, corpus, n, 256), qf)
    got = sharded.query_arrays(q)
    want = single.query_arrays(q)
    for g, w_ in zip(got, want):
        assert (g.view("int32") == w_.view("int32")).all()
    sharded.delete(torch.arange(5, n, 13, device="cuda"))
    sharded.insert(_as_layout(cp_random_data(gen, dims, 3, batch=300), cf))
    for probes in (1, 4):
        _k1s_vs_plain(sharded, q, probes)


def _ragged_tt(gen, dims, ranks, n):
    """n TT items of TT ranks ``ranks`` (r_0 .. r_N), N(0, 1) entries over
    sqrt(r_{n-1} d_n) (the scale of ``tt_random_data``)."""
    return TTTensor(tuple(
        torch.randn((n, ranks[i], d, ranks[i + 1]), generator=gen,
                    device="cuda") / (ranks[i] * d) ** 0.5
        for i, d in enumerate(dims)), 1.0)


def _tt_dense_rows(x):
    """A batch of TT items as a dense batch (exactly the chain's entries
    in float32, row by row)."""
    from repro_torch.core.tensor_formats import DenseTensor, tt_to_dense
    rows = torch.stack([tt_to_dense(x.index(i))
                        for i in range(x.cores[0].shape[0])])
    return DenseTensor(rows, x.dims)


# (mode dims, TT ranks, CP query rank): TT ranks 1 to 4, ragged, the
# rows' rank 4 (16-byte rank rows) and below; four modes; d_1 = 13
TT_PAIR_SHAPES = [((6, 5, 7), (1, 1, 1, 1), 2), ((6, 5, 7), (1, 2, 2, 1), 1),
                  ((6, 5, 7), (1, 3, 2, 1), 3), ((6, 5, 7), (1, 4, 4, 1), 4),
                  ((13, 4, 3), (1, 4, 3, 1), 6),
                  ((4, 3, 5, 2), (1, 2, 4, 3, 1), 4)]


@pytest.mark.parametrize("qf", ["cp", "dense"])
@pytest.mark.parametrize("shape", TT_PAIR_SHAPES, ids=str)
def test_fused_query_tt_pair_ranks(gen, shape, qf):
    """CP and dense queries over TT rows of ranks at most 4 (two rows a
    warp, a row a half-warp) against K1's plain version at TT ranks 1 to 4,
    ragged, over three and four modes, CP query ranks 1 to 6 (two chunks of
    four), the exact cap at T = 1 and a live window after deletes and an
    insert at T = 4: candidate counts equal, scores within
    ``parity.rerank_bound``, ids equal but at near ties; a dense query of an
    item's own entries finds it."""
    from repro_torch.serving.lsh_service import build_service
    dims, ranks, rq = shape
    n = 3000
    corpus = _ragged_tt(gen, dims, ranks, n)
    name = f"mixed:{qf}-tt"
    for probes, cap in ((1, None), (4, 16)):
        svc = build_service(gen, "cp-e2lsh", dims, corpus, num_codes=4,
                            num_tables=4, rank=2, bucket_width=1.0,
                            bucket_cap=cap, probes=probes)
        if cap is not None:
            svc.delete(list(range(1, n, 9)))
            svc.insert(_ragged_tt(gen, dims, ranks, 200))
        qid = torch.randint(0, n, (192,), generator=gen, device="cuda")
        if qf == "dense":
            q = _tt_dense_rows(corpus.index(qid))
        else:
            q = cp_random_data(gen, dims, rq, batch=192)
        before = fused_query.branches[name]
        nc = _k1_vs_plain(svc, q, probes)
        assert fused_query.branches[name] == before + 1
        assert int(nc.sum()) > 0
        if qf == "dense" and cap is None:
            ids, _, _ = svc.index.query_batch(q, topk=1)
            assert float((ids[:, 0].long() == qid).float().mean()) > 0.9


@pytest.mark.parametrize("qf", ["cp", "dense"])
def test_fused_query_tt_pair_scratch_equals_plain(gen, qf):
    """A heavy query over TT rows: one item repeated past the largest
    shared window, so its window goes to the global scratch, in one batch
    with queries whose windows fit; integer-valued CP data held as TT
    (exact sums in any order), so K1 equals its plain version bit for bit,
    the repeats tied at distance 0 in effective-id order."""
    from repro_torch.core.tensor_formats import cp_to_tt
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 6, 6), 6000
    dup = 3 * fq_mod.MAX_WINDOW // 4
    base = CPTensor(tuple(
        torch.randint(-1, 2, (n, d, 2), generator=gen, device="cuda").float()
        for d in dims), 1.0)
    rows = torch.cat([torch.arange(n, device="cuda"),
                      torch.zeros(dup, dtype=torch.long, device="cuda")])
    corpus = _repeat(base, rows[torch.randperm(n + dup, generator=gen,
                                               device="cuda")])
    svc = build_service(gen, "cp-e2lsh", dims, cp_to_tt(corpus), num_codes=6,
                        num_tables=4, rank=2, bucket_width=4.0)
    q = _repeat(base, torch.cat([
        torch.zeros(32, dtype=torch.long, device="cuda"),
        torch.randint(1, n, (96,), generator=gen, device="cuda")]))
    q = _as_layout(q, qf)
    before = _scratch_queries()
    ids, sc, nc = _bitwise_vs_plain(svc, q, 1)
    assert 32 <= _scratch_queries() - before < 128
    assert bool((sc[:32] == 0).all()) and bool(
        (ids[:32, 1:] > ids[:32, :-1]).all())


@pytest.mark.parametrize("qf", ["cp", "dense"])
def test_fused_query_tt_ranks_past_four_match_plain(gen, qf):
    """TT rows of ranks 5 to 16 (``<16, 0>``, ``<16, kDense>``: one row a
    warp, read in place) against K1's plain version, beside the branches
    over ranks at most 4."""
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 5, 7), 2000
    corpus = _ragged_tt(gen, dims, (1, 6, 5, 1), n)
    svc = build_service(gen, "cp-e2lsh", dims, corpus, num_codes=4,
                        num_tables=4, rank=2, bucket_width=1.0)
    assert fq_mod.instance("tt", qf, 3, 6, 3, 7)[0] == 16
    qid = torch.randint(0, n, (128,), generator=gen, device="cuda")
    q = (_tt_dense_rows(corpus.index(qid)) if qf == "dense"
         else cp_random_data(gen, dims, 3, batch=128))
    nc = _k1_vs_plain(svc, q, 1)
    assert int(nc.sum()) > 0


@pytest.mark.parametrize("qf", ["cp", "dense"])
def test_fused_query_tt_long_rows_read_in_place(gen, qf):
    """TT rows of rank 4 longer than ``TT_PAIR_ROW`` floats (12,288 bytes
    here; 24 staged would not fit a block) go to ``<16, 0>`` /
    ``<16, kDense>``, which read them in place, and answer as K1's plain
    version does."""
    from repro_torch.serving.lsh_service import build_service
    dims, n = (32, 32, 64), 2000
    corpus = _ragged_tt(gen, dims, (1, 4, 4, 1), n)
    svc = build_service(gen, "cp-e2lsh", dims, corpus, num_codes=4,
                        num_tables=4, rank=2, bucket_width=1.0)
    assert fq_mod.instance("tt", qf, 4, 4, 3, max(dims))[0] == 16
    qid = torch.randint(0, n, (64,), generator=gen, device="cuda")
    q = (_tt_dense_rows(corpus.index(qid)) if qf == "dense"
         else cp_random_data(gen, dims, 4, batch=64))
    nc = _k1_vs_plain(svc, q, 1)
    assert int(nc.sum()) > 0


# (mode dims, TT query ranks, CP row rank): TT query ranks 1 to 4, ragged,
# the rank-4 query's 16-byte rank rows and below; CP row ranks 1 to 6 (two
# chunks of four); four modes; d_1 = 13
CP_PAIR_SHAPES = [((6, 5, 7), (1, 1, 1, 1), 1), ((6, 5, 7), (1, 2, 2, 1), 2),
                  ((6, 5, 7), (1, 3, 2, 1), 3), ((6, 5, 7), (1, 4, 4, 1), 4),
                  ((13, 4, 3), (1, 4, 3, 1), 6),
                  ((4, 3, 5, 2), (1, 2, 4, 3, 1), 5)]


@pytest.mark.parametrize("shape", CP_PAIR_SHAPES, ids=str)
def test_fused_query_cp_pair_ranks(gen, shape):
    """TT queries of ranks at most 4 over CP rows (``<0, 4>``: two rows a
    warp, a row a half-warp, two buffers) against K1's plain version at
    TT query ranks 1 to 4, ragged, over three and four modes, CP row ranks
    1 to 6, the exact cap at T = 1 and a live window after deletes and an
    insert at T = 4: candidate counts equal, scores within
    ``parity.rerank_bound``, ids equal but at near ties; each launch
    counted under ``k1:<0, 4>``; a TT query of an item's own entries finds
    it."""
    from repro_torch.core.tensor_formats import cp_to_tt
    from repro_torch.serving.lsh_service import build_service
    dims, ranks, rc = shape
    n = 3000
    corpus = cp_random_data(gen, dims, rc, batch=n)
    for probes, cap in ((1, None), (4, 16)):
        svc = build_service(gen, "tt-e2lsh", dims, corpus, num_codes=4,
                            num_tables=4, rank=2, bucket_width=2.0,
                            bucket_cap=cap, probes=probes)
        if cap is not None:
            svc.delete(list(range(1, n, 9)))
            svc.insert(cp_random_data(gen, dims, rc, batch=200))
        q = _ragged_tt(gen, dims, ranks, 192)
        assert fq_mod.instance("cp", "tt", max(ranks), rc, len(dims),
                               max(dims)) == (0, 4)
        before = fused_query.branches["k1:<0, 4>"]
        nc = _k1_vs_plain(svc, q, probes)
        assert fused_query.branches["k1:<0, 4>"] == before + 1
        assert int(nc.sum()) > 0
        if rc <= 4 and cap is None:
            qid = torch.randint(0, n, (64,), generator=gen, device="cuda")
            own = cp_to_tt(corpus.index(qid))
            if max(own.ranks) <= 4:
                ids, _, _ = svc.index.query_batch(own, topk=1)
                assert torch.equal(ids[:, 0].long(), qid)


def test_fused_query_cp_pair_scratch_equals_plain(gen):
    """A heavy TT query over CP rows: one item repeated past the largest
    shared window, so its window goes to the global scratch, in one batch
    with queries whose windows fit; integer-valued data (exact sums in any
    order), so ``<0, 4>`` equals K1's plain version bit for bit, the
    repeats tied at distance 0 in effective-id order; K1s over S = 3
    likewise."""
    from repro_torch.core.tensor_formats import cp_to_tt
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 6, 6), 6000
    dup = 3 * 3 * fq_mod.MAX_WINDOW // 4
    base = CPTensor(tuple(
        torch.randint(-1, 2, (n, d, 2), generator=gen, device="cuda").float()
        for d in dims), 1.0)
    rows = torch.cat([torch.arange(n, device="cuda"),
                      torch.zeros(dup, dtype=torch.long, device="cuda")])
    corpus = _repeat(base, rows[torch.randperm(n + dup, generator=gen,
                                               device="cuda")])
    q = cp_to_tt(_repeat(base, torch.cat([
        torch.zeros(32, dtype=torch.long, device="cuda"),
        torch.randint(1, n, (96,), generator=gen, device="cuda")])))
    for shards in (None, 3):
        svc = build_service(gen, "cp-e2lsh", dims, corpus, num_codes=6,
                            num_tables=4, rank=2, bucket_width=4.0,
                            shards=shards)
        kernel = fused_query_sharded if shards else fused_query
        before = (_scratch_queries(), kernel.branches["k1:<0, 4>"])
        ids, sc, nc = _bitwise_vs_plain(svc, q, 1)
        assert 32 <= _scratch_queries() - before[0] < 128
        assert kernel.branches["k1:<0, 4>"] == before[1] + 1
        assert bool((sc[:32] == 0).all()) and bool(
            (ids[:32, 1:] > ids[:32, :-1]).all())


def test_fused_query_sharded_cp_pair_matches_plain(gen):
    """K1s with TT queries of rank 3 over CP rows (``<0, 4>``), S = 3 (a
    padded last shard), after deletes and a routed insert, at T = 1 and 4:
    against its plain version, and equal to the single-device index bit
    for bit before the mutations."""
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 5, 7), 3001
    corpus, single = _mixed_service(gen, dims, n, "cp")
    sharded = build_service(None, "tt-e2lsh", dims, corpus, shards=3,
                            family=single.index.family, num_codes=4,
                            num_tables=4, bucket_width=2.0)
    q = _as_layout(_planted(gen, corpus, n, 256), "tt")
    for g, w_ in zip(sharded.query_arrays(q), single.query_arrays(q)):
        assert (g.view("int32") == w_.view("int32")).all()
    sharded.delete(torch.arange(5, n, 13, device="cuda"))
    sharded.insert(cp_random_data(gen, dims, 3, batch=300))
    for probes in (1, 4):
        before = fused_query_sharded.branches["k1:<0, 4>"]
        _k1s_vs_plain(sharded, q, probes)
        assert fused_query_sharded.branches["k1:<0, 4>"] == before + 1


@pytest.mark.parametrize("ranks,rc", [((1, 5, 6, 1), 3), ((1, 8, 8, 1), 4),
                                      ((1, 4, 4, 1), 8), ((1, 16, 16, 1), 6),
                                      ((1, 3, 2, 1), 32)])
def test_fused_query_tt_queries_past_four_over_cp(gen, ranks, rc):
    """TT queries of ranks 5 to 16 over CP rows, and of rank <= 4 over CP
    rows past ``CP_PAIR_ROW`` floats (12 x 12 x 12 at rank 8: 288), take
    ``<0, 16>`` (two rows a warp, staged where the plan finds room: CP rank
    32's 1,152-float rows are read in place), against K1's plain
    version."""
    from repro_torch.serving.lsh_service import build_service
    dims, n = (12, 12, 12), 2000
    corpus = cp_random_data(gen, dims, rc, batch=n)
    svc = build_service(gen, "tt-e2lsh", dims, corpus, num_codes=4,
                        num_tables=4, rank=2, bucket_width=2.0)
    assert fq_mod.instance("cp", "tt", max(ranks), rc, 3, 12) == (0, 16)
    assert fq_mod.slot_plan("cp", "tt", 4, svc.index.cap, 3, 12, max(ranks),
                            rc, df=1728) == (rc < 32)
    before = fused_query.branches["k1:<0, 16>"]
    nc = _k1_vs_plain(svc, _ragged_tt(gen, dims, ranks, 128), 1)
    assert fused_query.branches["k1:<0, 16>"] == before + 1
    assert int(nc.sum()) > 0


def _pad_tt(x, rank):
    """A TT batch with its interior ranks zero-padded to ``rank``: the same
    tensor exactly."""
    cores, last = [], len(x.cores) - 1
    for k, c in enumerate(x.cores):
        shape = c.shape[:-3] + (1 if k == 0 else rank, c.shape[-2],
                                1 if k == last else rank)
        out = c.new_zeros(shape)
        out[..., :c.shape[-3], :, :c.shape[-1]] = c
        cores.append(out)
    return TTTensor(tuple(cores), x.scale)


# (mode dims, TT query ranks, CP row rank): ranks 5, 8, 12, 16 and ragged,
# CP row ranks 1 to 6 (two chunks a pass at rank 16)
WIDE_CP_SHAPES = [((12, 12, 12), (1, 5, 5, 1), 1),
                  ((12, 12, 12), (1, 8, 8, 1), 4),
                  ((12, 12, 12), (1, 12, 12, 1), 3),
                  ((12, 12, 12), (1, 16, 16, 1), 2),
                  ((6, 5, 7), (1, 5, 7, 1), 6),
                  ((6, 5, 7), (1, 16, 9, 1), 5)]


@pytest.mark.parametrize("shape", WIDE_CP_SHAPES, ids=str)
def test_fused_query_wide_cp_ranks(gen, shape):
    """TT queries of ranks 5 to 16 over CP rows (``<0, 16>``: two rows a
    warp, a row a half-warp, the states in registers) against K1's plain
    version at TT query ranks 5, 8, 12, 16 and ragged, CP row ranks 1 to
    6, the exact cap at T = 1 and a live window after deletes and an insert
    at T = 4 (two segments); each launch counted under ``k1:<0, 16>``; a
    TT query of an item's own entries, zero-padded to the query rank,
    finds it."""
    from repro_torch.core.tensor_formats import cp_to_tt
    from repro_torch.serving.lsh_service import build_service
    dims, ranks, rc = shape
    n = 3000
    corpus = cp_random_data(gen, dims, rc, batch=n)
    for probes, cap in ((1, None), (4, 16)):
        svc = build_service(gen, "tt-e2lsh", dims, corpus, num_codes=4,
                            num_tables=4, rank=2, bucket_width=2.0,
                            bucket_cap=cap, probes=probes)
        if cap is not None:
            svc.delete(list(range(1, n, 9)))
            svc.insert(cp_random_data(gen, dims, rc, batch=200))
        q = _ragged_tt(gen, dims, ranks, 192)
        assert fq_mod.instance("cp", "tt", max(ranks), rc, len(dims),
                               max(dims)) == (0, 16)
        before = fused_query.branches["k1:<0, 16>"]
        nc = _k1_vs_plain(svc, q, probes)
        assert fused_query.branches["k1:<0, 16>"] == before + 1
        assert int(nc.sum()) > 0
        if cap is None and rc <= max(ranks):
            qid = torch.randint(0, n, (64,), generator=gen, device="cuda")
            own = _pad_tt(cp_to_tt(corpus.index(qid)), max(ranks))
            ids, _, _ = svc.index.query_batch(own, topk=1)
            assert float((ids[:, 0].long() == qid).float().mean()) > 0.95


def test_fused_query_wide_cp_scratch_equals_plain(gen):
    """A heavy rank-8 TT query over CP rows (``<0, 16>``): one item
    repeated past the largest shared window, so its window goes to the
    global scratch, in one batch with queries whose windows fit;
    integer-valued data zero-padded to rank 8 (exact sums in any order), so
    K1 equals its plain version bit for bit, the repeats tied at distance 0
    in effective-id order; K1s over S = 3 likewise."""
    from repro_torch.core.tensor_formats import cp_to_tt
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 6, 6), 6000
    dup = 3 * 3 * fq_mod.MAX_WINDOW // 4
    base = CPTensor(tuple(
        torch.randint(-1, 2, (n, d, 2), generator=gen, device="cuda").float()
        for d in dims), 1.0)
    rows = torch.cat([torch.arange(n, device="cuda"),
                      torch.zeros(dup, dtype=torch.long, device="cuda")])
    corpus = _repeat(base, rows[torch.randperm(n + dup, generator=gen,
                                               device="cuda")])
    q = _pad_tt(cp_to_tt(_repeat(base, torch.cat([
        torch.zeros(32, dtype=torch.long, device="cuda"),
        torch.randint(1, n, (96,), generator=gen, device="cuda")]))), 8)
    for shards in (None, 3):
        svc = build_service(gen, "cp-e2lsh", dims, corpus, num_codes=6,
                            num_tables=4, rank=2, bucket_width=4.0,
                            shards=shards)
        kernel = fused_query_sharded if shards else fused_query
        before = (_scratch_queries(), kernel.branches["k1:<0, 16>"])
        ids, sc, nc = _bitwise_vs_plain(svc, q, 1)
        assert 32 <= _scratch_queries() - before[0] < 128
        assert kernel.branches["k1:<0, 16>"] == before[1] + 1
        assert bool((sc[:32] == 0).all()) and bool(
            (ids[:32, 1:] > ids[:32, :-1]).all())


def test_fused_query_sharded_wide_cp_matches_plain(gen):
    """K1s with TT queries of rank 8 over CP rows (``<0, 16>``), S = 3 (a
    padded last shard), after deletes and a routed insert, at T = 1 and 4:
    against its plain version, and equal to the single-device index bit
    for bit before the mutations."""
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 5, 7), 3001
    corpus, single = _mixed_service(gen, dims, n, "cp")
    sharded = build_service(None, "tt-e2lsh", dims, corpus, shards=3,
                            family=single.index.family, num_codes=4,
                            num_tables=4, bucket_width=2.0)
    q = _ragged_tt(gen, dims, (1, 8, 8, 1), 256)
    for g, w_ in zip(sharded.query_arrays(q), single.query_arrays(q)):
        assert (g.view("int32") == w_.view("int32")).all()
    sharded.delete(torch.arange(5, n, 13, device="cuda"))
    sharded.insert(cp_random_data(gen, dims, 3, batch=300))
    for probes in (1, 4):
        before = fused_query_sharded.branches["k1:<0, 16>"]
        _k1s_vs_plain(sharded, q, probes)
        assert fused_query_sharded.branches["k1:<0, 16>"] == before + 1


# (mode dims, TT row ranks): ranks 5, 8 (2,304-float rows, the ring slots)
# and 16 (read in place), rank 6 rows of 756 floats (ring slots, ranks not a
# float4 multiple), rank 5 rows of 525 floats (whole floats, read in place),
# rank 4 rows past TT_PAIR_ROW in ring slots with a query row past
# DENSE_STAGE (22 x 22 x 22: 10,648 floats, read in place)
WIDE_TT_SHAPES = [((12, 12, 12), (1, 5, 5, 1)), ((12, 12, 12), (1, 8, 8, 1)),
                  ((12, 12, 12), (1, 16, 16, 1)), ((6, 5, 7), (1, 6, 5, 1)),
                  ((6, 5, 7), (1, 5, 5, 1)), ((22, 22, 22), (1, 4, 4, 1))]


@pytest.mark.parametrize("shape", WIDE_TT_SHAPES, ids=str)
def test_fused_query_dense_over_wide_tt(gen, shape):
    """Dense queries over TT rows of ranks 5 to 16 or past ``TT_PAIR_ROW``
    (``<16, kDense>``: a row a warp, through a ring slot where the plan
    gives one, else read in place; yy the squared entries of the sweep)
    against K1's plain version, the exact cap at T = 1 and a live window
    after deletes and an insert at T = 4; each launch counted under
    ``k1:<16, kDense>``; a dense query of an item's own entries finds
    it."""
    from repro_torch.serving.lsh_service import build_service
    dims, ranks = shape
    n = 2000
    corpus = _ragged_tt(gen, dims, ranks, n)
    r = max(ranks)
    fc = len(dims) * r * max(dims) * r
    assert fq_mod.instance("tt", "dense", 1, r, len(dims), max(dims)) == (
        16, fq_mod.DENSE)
    for probes, cap in ((1, None), (4, 16)):
        svc = build_service(gen, "cp-e2lsh", dims, corpus, num_codes=4,
                            num_tables=4, rank=2, bucket_width=1.0,
                            bucket_cap=cap, probes=probes)
        if cap is not None:
            svc.delete(list(range(1, n, 9)))
            svc.insert(_ragged_tt(gen, dims, ranks, 200))
        if probes == 1:
            assert fq_mod.slot_plan(
                "tt", "dense", 4, svc.index.cap, len(dims), max(dims), 1, r,
                df=math.prod(dims)) == (fq_mod.tt_ring_slot(fc) > 0)
        qid = torch.randint(0, n, (128,), generator=gen, device="cuda")
        q = _tt_dense_rows(corpus.index(qid))
        before = fused_query.branches["k1:<16, kDense>"]
        nc = _k1_vs_plain(svc, q, probes)
        assert fused_query.branches["k1:<16, kDense>"] == before + 1
        assert int(nc.sum()) > 0
        if cap is None:
            ids, _, _ = svc.index.query_batch(q, topk=1)
            assert float((ids[:, 0].long() == qid).float().mean()) > 0.9


def test_fused_query_sharded_dense_over_wide_tt(gen):
    """K1s with dense queries over TT rows of rank 8 (``<16, kDense>``,
    ring slots), S = 3, after deletes and a routed insert, at T = 1 and 4,
    against its plain version."""
    from repro_torch.serving.lsh_service import build_service
    dims, n = (12, 12, 12), 3001
    corpus = _ragged_tt(gen, dims, (1, 8, 8, 1), n)
    svc = build_service(gen, "cp-e2lsh", dims, corpus, num_codes=4,
                        num_tables=4, rank=2, bucket_width=1.0, shards=3)
    q = _tt_dense_rows(corpus.index(torch.randint(0, n, (128,),
                                                  generator=gen,
                                                  device="cuda")))
    svc.delete(torch.arange(5, n, 13, device="cuda"))
    svc.insert(_ragged_tt(gen, dims, (1, 8, 8, 1), 300))
    for probes in (1, 4):
        before = fused_query_sharded.branches["k1:<16, kDense>"]
        _k1s_vs_plain(svc, q, probes)
        assert fused_query_sharded.branches["k1:<16, kDense>"] == before + 1


@pytest.mark.parametrize("qf", ["cp", "tt"])
@pytest.mark.parametrize("dims,n", [
    ((12, 12, 12), 3000),     # [mixed * x dense]'s rows: the ring slots
    ((4, 4, 4), 3000),        # 64-float slots
    ((2, 1032), 3000),        # 2,064 floats: past the ring slot, in place
    ((6, 173), 3000),         # 1,038 floats: whole floats, in place
    ((16, 16, 16, 16), 1200),  # 65,536 floats: the query past the stage
])
def test_fused_query_dense_cross_ring_edges(gen, dims, n, qf):
    """CP and TT queries over dense rows (``<kDense, 0>``, ``<kDense,
    16>``: the dense instantiation's ring slots where the rows fit one,
    else read in place; the query densified into the staged row or, past
    ``DENSE_STAGE`` floats, the global scratch) against K1's plain version
    bit for bit on integer-valued data (exact sums in any order), the
    corpus the densified CP items and the queries some of those items, as
    CP or TT, beside queries far from every item; each finds itself."""
    from repro_torch.core.tensor_formats import cp_to_tt
    from repro_torch.serving.lsh_service import build_service
    base = CPTensor(tuple(
        torch.randint(-1, 2, (n, d, 2), generator=gen, device="cuda").float()
        for d in dims), 1.0)
    rows = _as_layout(base, "dense")
    w = float(torch.tensor(dims).prod()) ** 0.5
    svc = build_service(gen, "e2lsh", dims, rows, num_codes=4,
                        num_tables=4, bucket_width=w)
    qid = torch.randint(0, n, (96,), generator=gen, device="cuda")
    far = CPTensor(tuple(
        torch.randint(-1, 2, (32, d, 2), generator=gen, device="cuda").float()
        * (1000.0 if i == 0 else 1.0) for i, d in enumerate(dims)), 1.0)
    q = _repeat(base, qid)
    q = CPTensor(tuple(torch.cat(p) for p in zip(q.factors, far.factors)),
                 1.0)
    if qf == "tt":
        q = cp_to_tt(q)
    name = "k1:" + fq_mod.instance_name(fq_mod.DENSE, 0 if qf == "cp" else 16)
    before = fused_query.branches[name]
    ids, _, nc = _bitwise_vs_plain(svc, q, 1)
    assert fused_query.branches[name] == before + 1
    assert int(nc.sum()) > 0
    hit = ids[:96, 0].long() == qid
    same = (rows.data.flatten(1)[ids[:96, 0].long()]
            == rows.data.flatten(1)[qid]).all(1)
    assert bool((hit | same).all())


@pytest.mark.parametrize("ranks", [(1, 6, 5, 1), (1, 16, 16, 1)])
def test_fused_query_tt_ranks_past_four_over_dense(gen, ranks):
    """TT queries of ranks 5 to 16 over dense rows (``<kDense, 16>``: the
    query densified prefix by prefix through its rank-16 steps, qq by the
    rank-16 chain) against K1's plain version bit for bit on
    integer-valued data (exact sums in any order): the corpus the TT items'
    dense rows, the queries some of those items as TT; each finds
    itself."""
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 5, 7), 2000
    base = TTTensor(tuple(
        torch.randint(-1, 2, (n, ranks[i], d, ranks[i + 1]), generator=gen,
                      device="cuda").float() for i, d in enumerate(dims)), 1.0)
    rows = _tt_dense_rows(base)
    w = float(rows.data.flatten(1).norm(dim=1).mean())
    svc = build_service(gen, "e2lsh", dims, rows, num_codes=4, num_tables=4,
                        bucket_width=w)
    qid = torch.randint(0, n, (64,), generator=gen, device="cuda")
    before = fused_query.branches["k1:<kDense, 16>"]
    ids, _, nc = _bitwise_vs_plain(svc, base.index(qid), 1)
    assert fused_query.branches["k1:<kDense, 16>"] == before + 1
    assert int(nc.sum()) > 0
    same = (rows.data.flatten(1)[ids[:, 0].long()]
            == rows.data.flatten(1)[qid]).all(1)
    assert bool(same.all())


def _pad_tt(x, rank):
    """A TT batch with its interior ranks zero-padded to ``rank``: the same
    tensor exactly."""
    cores, last = [], len(x.cores) - 1
    for k, c in enumerate(x.cores):
        shape = c.shape[:-3] + (1 if k == 0 else rank, c.shape[-2],
                                1 if k == last else rank)
        out = c.new_zeros(shape)
        out[..., :c.shape[-3], :, :c.shape[-1]] = c
        cores.append(out)
    return TTTensor(tuple(cores), x.scale)


# (mode dims, the rows' TT ranks, the TT queries' ranks): ranks 5, 8 and 16,
# rank-8 rows of (12, 12, 12) through the ring slots ([tt8]'s; the rank-16
# queries over them read them in place), ragged ranks, four modes at rank 16
TT_WIDE_SHAPES = [((6, 5, 7), (1, 5, 5, 1), (1, 5, 5, 1)),
                  ((12, 12, 12), (1, 8, 8, 1), (1, 8, 8, 1)),
                  ((12, 12, 12), (1, 8, 8, 1), (1, 16, 16, 1)),
                  ((6, 5, 7), (1, 6, 7, 1), (1, 3, 8, 1)),
                  ((4, 3, 5, 2), (1, 9, 16, 12, 1), (1, 16, 16, 5, 1))]


@pytest.mark.parametrize("qf", ["cp", "tt"])
@pytest.mark.parametrize("shape", TT_WIDE_SHAPES, ids=str)
def test_fused_query_tt_wide_ranks(gen, shape, qf):
    """TT rows of ranks 5 to 16 with TT queries (``<8, 8>``, ``<16, 16>``:
    a row a warp, the two chains on the half-warps) and CP queries
    (``<16, 0>``: yy by the row's own chain, qy by ``cp_tt_rows``), rows
    through the ring slots or read in place, against K1's plain version,
    the exact cap at T = 1 and a live window after deletes and an insert at
    T = 4, each launch counted under its instantiation; an item's own TT
    row finds it."""
    from repro_torch.serving.lsh_service import build_service
    dims, ranks, qranks = shape
    n = 2000
    corpus = _ragged_tt(gen, dims, ranks, n)
    rc, rq = max(ranks), (max(qranks) if qf == "tt" else 3)
    tr_qr = fq_mod.instance("tt", qf, rq, rc, len(dims), max(dims))
    if qf == "cp":
        assert tr_qr == (16, 0)
    else:
        assert tr_qr == ((8, 8) if max(rq, rc) <= 8 else (16, 16))
    name = "k1:" + fq_mod.instance_name(*tr_qr)
    for probes, cap in ((1, None), (4, 16)):
        svc = build_service(gen, "cp-e2lsh", dims, corpus, num_codes=4,
                            num_tables=4, rank=2, bucket_width=1.0,
                            bucket_cap=cap, probes=probes)
        if cap is not None:
            svc.delete(list(range(1, n, 9)))
            svc.insert(_ragged_tt(gen, dims, ranks, 200))
        q = (_ragged_tt(gen, dims, qranks, 128) if qf == "tt"
             else cp_random_data(gen, dims, rq, batch=128))
        before = fused_query.branches[name]
        nc = _k1_vs_plain(svc, q, probes)
        assert fused_query.branches[name] == before + 1
        assert int(nc.sum()) > 0
        if cap is None:
            qid = torch.randint(0, n, (64,), generator=gen, device="cuda")
            ids, _, _ = svc.index.query_batch(corpus.index(qid), topk=1)
            assert float((ids[:, 0].long() == qid).float().mean()) > 0.9


@pytest.mark.parametrize("qf", ["cp", "tt"])
def test_fused_query_tt_wide_scratch_equals_plain(gen, qf):
    """A heavy query over TT rows of rank 8 (``<16, 0>``, ``<8, 8>``): one
    item repeated past the largest shared window, so its window goes to the
    global scratch, in one batch with queries whose windows fit;
    integer-valued CP data held as TT padded to rank 8 (exact sums in any
    order), so K1 equals its plain version bit for bit, the repeats tied at
    distance 0 in effective-id order."""
    from repro_torch.core.tensor_formats import cp_to_tt
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 6, 6), 6000
    dup = 3 * fq_mod.MAX_WINDOW // 4
    base = CPTensor(tuple(
        torch.randint(-1, 2, (n, d, 2), generator=gen, device="cuda").float()
        for d in dims), 1.0)
    rows = torch.cat([torch.arange(n, device="cuda"),
                      torch.zeros(dup, dtype=torch.long, device="cuda")])
    corpus = _repeat(base, rows[torch.randperm(n + dup, generator=gen,
                                               device="cuda")])
    svc = build_service(gen, "cp-e2lsh", dims, _pad_tt(cp_to_tt(corpus), 8),
                        num_codes=6, num_tables=4, rank=2, bucket_width=4.0)
    q = _repeat(base, torch.cat([
        torch.zeros(32, dtype=torch.long, device="cuda"),
        torch.randint(1, n, (96,), generator=gen, device="cuda")]))
    q = _pad_tt(cp_to_tt(q), 8) if qf == "tt" else q
    name = "k1:<16, 0>" if qf == "cp" else "k1:<8, 8>"
    before, scratch = fused_query.branches[name], _scratch_queries()
    ids, sc, nc = _bitwise_vs_plain(svc, q, 1)
    assert fused_query.branches[name] == before + 1
    assert 32 <= _scratch_queries() - scratch < 128
    assert bool((sc[:32] == 0).all()) and bool(
        (ids[:32, 1:] > ids[:32, :-1]).all())


@pytest.mark.parametrize("qf", ["cp", "tt"])
def test_fused_query_sharded_tt_wide(gen, qf):
    """K1s with CP and TT queries over TT rows of rank 8 (``<16, 0>``,
    ``<8, 8>``: ring slots), S = 3, after deletes and a routed insert, at
    T = 1 and 4, against its plain version."""
    from repro_torch.serving.lsh_service import build_service
    dims, n = (12, 12, 12), 3001
    corpus = _ragged_tt(gen, dims, (1, 8, 8, 1), n)
    svc = build_service(gen, "cp-e2lsh", dims, corpus, num_codes=4,
                        num_tables=4, rank=2, bucket_width=1.0, shards=3)
    q = (_ragged_tt(gen, dims, (1, 8, 8, 1), 128) if qf == "tt"
         else cp_random_data(gen, dims, 4, batch=128))
    svc.delete(torch.arange(5, n, 13, device="cuda"))
    svc.insert(_ragged_tt(gen, dims, (1, 8, 8, 1), 300))
    name = "k1:<16, 0>" if qf == "cp" else "k1:<8, 8>"
    for probes in (1, 4):
        before = fused_query_sharded.branches[name]
        _k1s_vs_plain(svc, q, probes)
        assert fused_query_sharded.branches[name] == before + 1


# ---------------------------------------------------------------------------
# The sampling modes: K1's and K1s's sampling instantiations
# (fused_query_kernel<TR, QR, true>) against their plain versions
# ---------------------------------------------------------------------------

SAMPLE_KEY = (0x9E3779B9, 12345)


def _sample_vs_plain(svc, q, probes, mode, topk=10, bitwise=False):
    """K1's (K1s's) sample mode against its plain version on the same raw
    values and key: the launch counted under "sample:<mode>"; candidate
    counts equal bit for bit and equal to the top-k path's; the drawn sets
    equal (in "weighted" but where ``parity.sample_mismatches`` allows),
    distinct, min(topk, n_cand) of them; where the sets are equal, scores
    within ``parity.rerank_bound`` and ids in order but at near ties, or
    (``bitwise``, integer data) ids, scores and counts bit for bit."""
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
    name = f"sample:{mode}"
    before = kernel.branches[name]
    got = kernel(values, fam.offsets, idx._mults_t, qs, *args,
                 table=view.k1_table, mode=mode, key=SAMPLE_KEY, **kw)
    top = kernel(values, fam.offsets, idx._mults_t, qs, *args,
                 table=view.k1_table, **kw)
    want = plain(values, fam.offsets, idx._mults_t, qs, *args, mode=mode,
                 key=SAMPLE_KEY, **kw)
    torch.cuda.synchronize()
    assert kernel.branches[name] == before + 1
    ids, sc, nc = got
    ids_p, sc_p, nc_p = want
    assert torch.equal(nc, nc_p) and torch.equal(nc, top[2])
    valid = ids >= 0
    assert torch.equal(valid.sum(1), nc.clamp(max=topk))
    srt = torch.sort(torch.where(valid, ids, -1 - torch.arange(
        topk, device="cuda")), dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())       # distinct
    if bitwise:
        for g, w_ in zip(got, want):
            assert torch.equal(g.view(torch.int32), w_.view(torch.int32))
        return got
    segs, caps = view.k1_segments
    union = fq_mod.sample_union(values, fam.offsets, idx._mults_t, segs,
                                kind=fam.kind, w=fam.bucket_width,
                                num_tables=fam.num_tables,
                                num_codes=fam.num_codes, caps=caps,
                                probes=probes)
    assert parity.sample_mismatches(mode, SAMPLE_KEY, ids, ids_p, union) == 0
    rows = torch.tensor([set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                         for a, b in zip(ids, ids_p)], device="cuda")
    if mode == "uniform":
        assert bool(rows.all())
    tol = parity.rerank_bound(idx.metric, q, idx.effective_corpus(), ids_p,
                              sc_p)
    same = (ids == ids_p) & (ids_p >= 0) & rows[:, None]
    assert bool(((sc - sc_p).abs()[same] <= tol[same]).all())
    assert parity.topk_mismatches(ids[rows], sc[rows], ids_p[rows],
                                  sc_p[rows], tol[rows]) == 0
    assert bool((ids < idx.size).all())
    return got


def _sample_service(gen, layout, n, **kw):
    """A corpus of ``layout`` ("cp"; "tt4" / "tt8": TT ranks 4 / 8; "dense")
    and its service -> (corpus, service)."""
    from repro_torch.serving.lsh_service import build_service
    if layout == "dense":
        return _dense_service(gen, (12, 12, 12), n, **kw)
    if layout == "cp":
        dims, kind, w = (6, 6, 6), "cp-e2lsh", 2.0
        corpus = cp_random_data(gen, dims, 3, batch=n)
    else:
        dims, kind, w = (8, 8, 8), "tt-e2lsh", 8.0
        corpus = tt_random_data(gen, dims, int(layout[2:]), batch=n)
    return corpus, build_service(gen, kind, dims, corpus, num_codes=6,
                                 num_tables=4, rank=2, bucket_width=w, **kw)


@pytest.mark.parametrize("mode", ["uniform", "weighted"])
@pytest.mark.parametrize("layout,probes,cap", [
    ("cp", 1, None), ("cp", 8, None), ("cp", 4, 16), ("tt4", 1, None),
    ("tt8", 4, 16), ("dense", 1, None), ("dense", 8, None)])
def test_fused_query_sample_matches_plain(gen, layout, probes, cap, mode):
    """The sample mode of <0, 0>, <4, 4>, <8, 8> and <kDense, kDense> at
    T = 1 and 8 (dense windows) and, with ``bucket_cap``, after deletes and
    an insert (a live window over two segments) at T = 4."""
    n = 6000 if layout.startswith("tt") else 20000
    corpus, svc = _sample_service(gen, layout, n, bucket_cap=cap)
    if cap is not None:
        svc.delete(torch.randperm(n, generator=gen, device="cuda")[:n // 3])
        svc.insert(corpus.index(slice(0, 300)) if layout != "dense"
                   else corpus[:300])
    q = (corpus[torch.randint(0, n, (256,), generator=gen, device="cuda")]
         + 0.05 * torch.randn((256,) + corpus.shape[1:], generator=gen,
                              device="cuda")
         if layout == "dense" else _planted(gen, corpus, n, 256))
    ids, _, nc = _sample_vs_plain(svc, as_batch(q, 3), probes, mode)
    assert int(nc.sum()) > 0
    assert (ids >= 0).sum() > 0


@pytest.mark.parametrize("qf,cf", [("tt", "cp"), ("dense", "cp"),
                                   ("cp", "tt"), ("tt", "dense")])
@pytest.mark.parametrize("mode", ["uniform", "weighted"])
def test_fused_query_sample_mixed_matches_plain(gen, qf, cf, mode):
    """The sample mode of four cross-format instantiations, T = 4 over a
    live window after deletes."""
    dims, n = (6, 5, 7), 3000
    corpus, svc = _mixed_service(gen, dims, n, cf, bucket_cap=16)
    svc.delete(list(range(1, n, 9)))
    q = _planted(gen, corpus, n, 256)
    before = fused_query.branches[f"mixed:{qf}-{cf}"]
    _sample_vs_plain(svc, _as_layout(q, qf), 4, mode)
    # the sampling launch and the top-k one beside it
    assert fused_query.branches[f"mixed:{qf}-{cf}"] == before + 2


@pytest.mark.parametrize("layout,shards", [("cp", 1), ("tt", 1), ("cp", 3),
                                           ("tt", 3)])
def test_fused_query_sample_spill_equals_shared(gen, layout, shards):
    """test_fused_query_spill_equals_shared's store (one item repeated past
    the shared window, deltas, deletes) in both sampling modes: the queries
    that take the global scratch (6 words a slot) and those that do not
    draw as the plain version does, ids, scores and counts bit for bit (the
    integer data scores exactly), K1 and K1s, T = 1 and 4, with top-k
    launches between them on the same scratch."""
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
    more = _integer_data(gen, layout, dims, 300)
    copies = _repeat(base, torch.zeros(200, dtype=torch.long, device="cuda"))
    svc.insert(type(base)(tuple(torch.cat(pair) for pair in zip(
        more.leaves, copies.leaves)), 1.0))
    svc.delete(torch.arange(0, svc.index.size, 9, device="cuda"))
    q = _repeat(base, torch.cat([
        torch.zeros(64, dtype=torch.long, device="cuda"),
        torch.randint(1, n, (192,), generator=gen, device="cuda")]))
    for probes, mode in ((1, "uniform"), (4, "weighted"), (4, "uniform"),
                         (1, "weighted")):
        before = _scratch_queries()
        ids, _, nc = _sample_vs_plain(svc, q, probes, mode, bitwise=True)
        took = _scratch_queries() - before
        assert 64 <= took < 2 * 256     # the sample launch and the top-k one
        assert bool((nc[:64] > 10).all())
        _bitwise_vs_plain(svc, q, probes)


@pytest.mark.parametrize("layout", ["cp", "tt"])
def test_sample_sharded_equals_single_device(gen, layout):
    """Effective ids are unique across shards and the noise is keyed by
    them: ``shards=3`` draws what the single index draws from the same
    seed, ids, scores and counts bit for bit; a seed replays its draw."""
    from repro_torch.serving.lsh_service import build_service
    n = 12001
    data = cp_random_data if layout == "cp" else tt_random_data
    dims = (6, 6, 6) if layout == "cp" else (8, 8, 8)
    kw = dict(num_codes=8, num_tables=4, rank=2,
              bucket_width=2.0 if layout == "cp" else 8.0)
    corpus = data(gen, dims, 3, batch=n)
    single = build_service(gen, f"{layout}-e2lsh", dims, corpus, **kw)
    sharded = build_service(None, f"{layout}-e2lsh", dims, corpus, shards=3,
                            family=single.index.family, **kw)
    for svc in (single, sharded):
        svc.insert(corpus.index(slice(0, 300)))
        svc.delete(torch.arange(7, n, 11, device="cuda"))
    q = _planted(gen, corpus, n, 256)
    for mode, probes in (("uniform", 1), ("weighted", 3)):
        want = single.query_arrays(q, probes=probes, mode=mode, seed=5)
        for got in (sharded.query_arrays(q, probes=probes, mode=mode,
                                         seed=5),
                    single.query_arrays(q, probes=probes, mode=mode,
                                        seed=5)):
            for g, w_ in zip(got, want):
                assert (g.view("int32") == w_.view("int32")).all()
    assert fused_query_sharded.branches["sample:weighted"] > 0


def test_tt_rank_20_is_refused_by_name(gen):
    """A TT of rank 20 (``dense_to_tt`` of an (8, 8, 8, 8) tensor at
    max_rank 20: ranks (8, 20, 8)) gets K4's and K1's named refusals on the
    card, not a truncation."""
    from repro_torch.core.tensor_formats import dense_to_tt
    from repro_torch.serving.lsh_service import build_service
    dims = (8, 8, 8, 8)
    tt = dense_to_tt(torch.randn(dims, generator=gen, device="cuda"), 20)
    assert tt.ranks == (1, 8, 20, 8, 1)
    batch = TTTensor(tuple(c[None] for c in tt.cores), 1.0)
    kw = dict(num_codes=4, num_tables=2, rank=2, bucket_width=4.0)
    tsvc = build_service(gen, "tt-e2lsh", dims,
                         tt_random_data(gen, dims, 2, batch=512), **kw)
    with pytest.raises(ValueError, match="K4 takes ranks up to 16"):
        tsvc.query_arrays(batch)
    csvc = build_service(gen, "cp-e2lsh", dims,
                         cp_random_data(gen, dims, 2, batch=512), **kw)
    with pytest.raises(ValueError, match="K1 takes TT ranks up to 16"):
        csvc.query_arrays(batch)


@pytest.mark.parametrize("kind", ["cp-e2lsh", "cp-srp", "tt-e2lsh",
                                  "tt-srp"])
def test_single_item_hash_through_the_kernel(gen, kind):
    """``hash(x)`` of one CP (TT) item is one K3 (K4) launch, its codes
    equal to the plain version's on the CPU except within
    ``parity.family_raw_bound`` of a bucket edge or of 0; for the SRP kinds
    ``hash_packed(x)`` equals the packed codes."""
    from repro_torch.core.lsh import make_family, pack_bits
    from repro_torch.kernels.cp_gram import cp_gram as k3
    from repro_torch.kernels.tt_inner import tt_inner as k4
    layout, dims = kind[:2], (5, 6, 4)
    data = cp_random_data if layout == "cp" else tt_random_data
    fam = make_family(gen, kind, dims, num_codes=12, num_tables=3, rank=3,
                      bucket_width=1.0)
    xs = data(gen, dims, 3, batch=9)
    kernel = k3 if layout == "cp" else k4
    for i in range(xs.leaves[0].shape[0]):
        x = xs.index(i)
        before = kernel.launches
        codes = fam.hash(x)
        assert kernel.launches == before + 1 and codes.shape == (3, 12)
        fam_c, one = fam.to("cpu"), as_batch(x.to("cpu")).index(None)
        want = fam_c.hash(x.to("cpu"))
        raw = fam_c.raw_projections(x.to("cpu")).reshape(1, 3, 12)
        near = parity.boundary_codes(
            raw, parity.family_raw_bound(fam_c, one).reshape(1, 3, 12),
            kind, None if fam_c.offsets is None
            else fam_c.offsets.reshape(3, 12), 1.0)[0]
        assert bool(((codes.cpu() == want) | near).all())
        if kind.endswith("srp"):
            assert torch.equal(fam.hash_packed(x), pack_bits(codes))


def _index_pair(gen, layout, shards, host=False):
    """An index over integer-valued items on the card and its twin over the
    same items and family on the CPU (raw values exact, so keys agree bit
    for bit): the device or sharded one after an insert and deletes, or
    the host index."""
    from repro_torch.core.index import (DeviceLSHIndex, HostLSHIndex,
                                        ShardedLSHIndex)
    from repro_torch.core.lsh import make_family
    dims, n = ((5, 5, 5) if layout == "cp" else (4, 5, 4)), 3001
    fam = make_family(gen, f"{layout}-e2lsh", dims, num_codes=5,
                      num_tables=4, rank=2, bucket_width=3.0)
    corpus = _integer_data(gen, layout, dims, n)
    extra = _integer_data(gen, layout, dims, 300)
    pair = []
    for dev in ("cuda", "cpu"):
        f = fam.to(dev)
        if host:
            pair.append(HostLSHIndex(f).build(corpus.to(dev)))
            continue
        idx = (DeviceLSHIndex(f) if shards is None
               else ShardedLSHIndex(f, shards=shards)).build(corpus.to(dev))
        idx.insert(extra.to(dev))
        idx.delete(list(range(3, n, 7)))
        pair.append(idx)
    q = _repeat(corpus, torch.arange(0, 200, device="cuda"))
    return pair, q


@pytest.mark.parametrize("layout,shards", [("cp", None), ("tt", None),
                                           ("cp", 3), ("tt", 3)])
def test_candidates_batch_on_card_equals_cpu(gen, layout, shards):
    """``candidates_batch`` on the card (K3 / K4's raw values, the windows
    on the card) equals its CPU run over the same mutated store bit for
    bit, at T = 1 and 4; each row's count is K1's n_candidates, and the
    single-query ``candidates`` / ``query`` equal the CPU's."""
    (card, cpu), q = _index_pair(gen, layout, shards)
    for probes in (1, 4):
        cand, valid = card.candidates_batch(q, probes=probes)
        cand_c, valid_c = cpu.candidates_batch(q.to("cpu"), probes=probes)
        assert torch.equal(cand.cpu(), cand_c)
        assert torch.equal(valid.cpu(), valid_c)
        _, _, n_cand = card.query_batch(q, probes=probes)
        assert torch.equal(valid.sum(1, dtype=torch.int32), n_cand)
        for i in (0, 7, 199):
            x = q.index(i)
            got = card.candidates(x, probes=probes)
            assert (got == cpu.candidates(x.to("cpu"), probes=probes)).all()
            ids, scores, nc = card.query(x, probes=probes)
            ids_c, scores_c, nc_c = cpu.query(x.to("cpu"), probes=probes)
            assert (ids == ids_c).all() and (scores == scores_c).all()
            assert nc == nc_c == got.size


@pytest.mark.parametrize("layout", ["cp", "tt"])
def test_host_index_on_card_equals_cpu(gen, layout):
    """``HostLSHIndex`` on the card: the dicts' candidates (``hash(x)``
    through K3 / K4 at T = 1, the hash path's raw values at T = 4) equal
    the CPU index's and K1's counts; ``query_batch`` through K1 equals the
    CPU's plain K1 bit for bit."""
    (card, cpu), q = _index_pair(gen, layout, None, host=True)
    for probes in (1, 4):
        got = card.query_batch(q, probes=probes)
        want = cpu.query_batch(q.to("cpu"), probes=probes)
        for g, w_ in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32),
                               w_.view(torch.int32))
        for i in (0, 11, 150):
            x = q.index(i)
            cand = card.candidates(x, probes=probes)
            assert (cand == cpu.candidates(x.to("cpu"), probes=probes)).all()
            assert cand.size == int(got[2][i])


def test_cp_queries_over_a_64_cube_tt_corpus(gen):
    """CP queries over TT rows of dims (64, 64, 64) (prod d 262,144, a pair
    with no dense side) are answered: K1 launches ``<16, 0>`` and matches
    its plain version. K1 used to hold every cross pair's prod d to
    MAX_DENSE_ROW and refused this one."""
    from repro_torch.core.tensor_formats import cp_to_tt
    from repro_torch.serving.lsh_service import build_service
    dims, n = (64, 64, 64), 2000
    corpus = cp_random_data(gen, dims, 4, batch=n)
    svc = build_service(gen, "tt-e2lsh", dims, cp_to_tt(corpus),
                        num_codes=4, num_tables=4, rank=2, bucket_width=2.0)
    q = _planted(gen, corpus, n, 64)
    before = fused_query.branches["k1:<16, 0>"]
    nc = _k1_vs_plain(svc, q, 1)
    assert fused_query.branches["k1:<16, 0>"] == before + 1
    ids, _, _ = svc.query_arrays(q, topk=10)
    assert int(nc.sum()) > 0 and (ids[:, 0] >= 0).any()


# ---------------------------------------------------------------------------
# The serving scheduler's two streams
# ---------------------------------------------------------------------------


def _sched_service(gen, n=4000, shards=None, **kw):
    from repro_torch.serving.lsh_service import build_service
    dims = (6, 6, 6)
    corpus = cp_random_data(gen, dims, 3, batch=n)
    svc = build_service(gen, "cp-e2lsh", dims, corpus, num_codes=6,
                        num_tables=4, rank=2, bucket_width=2.0,
                        shards=shards, **kw)
    return svc, corpus


def test_scheduler_lanes_run_on_their_own_streams(gen):
    """The query lane runs on a stream of the highest priority, the ingest
    lane on another; neither is the default stream; each lane's kernels
    launch on its stream and count on its lane; scheduled rows equal the
    direct batch's bit for bit."""
    from repro_torch.serving import scheduler as sched_mod
    svc, corpus = _sched_service(gen)
    q = _planted(gen, corpus, corpus.leaves[0].shape[0], 24)
    direct = svc.query_arrays(q, topk=10)
    seen = {}
    idx = svc.index
    for name in ("query_batch", "insert"):
        fn = getattr(idx, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            seen.setdefault(_name, set()).add(
                torch.cuda.current_stream().cuda_stream)
            return _fn(*a, **kw)
        setattr(idx, name, spy)
    for f in (fused_query, cp_gram):
        f.lanes.clear()
    with sched_mod.ServingScheduler(svc, max_batch=8) as sched:
        qs, ing = sched.streams[svc.device]
        futs = [sched.query(q.index(i)) for i in range(24)]
        got = [f.result(timeout=60) for f in futs]
        sched.insert(corpus.index(slice(0, 64))).result(timeout=60)
    default = torch.cuda.default_stream(svc.device).cuda_stream
    assert len({qs.cuda_stream, ing.cuda_stream, default}) == 3
    assert qs.priority < ing.priority
    assert qs.priority == torch.cuda.Stream(priority=-(1 << 10)).priority
    assert seen == {"query_batch": {qs.cuda_stream},
                    "insert": {ing.cuda_stream}}
    assert fused_query.lanes[sched_mod.QUERY_LANE] >= 3
    assert cp_gram.lanes[sched_mod.QUERY_LANE] >= 3
    assert cp_gram.lanes[sched_mod.INGEST_LANE] == 1
    for i, (ids, sc, nc) in enumerate(got):
        assert (ids == direct[0][i]).all() and nc == direct[2][i]
        assert (sc.view("int32") == direct[1][i].view("int32")).all()


def test_view_published_on_ingest_stream_is_read_after_its_event(gen,
                                                                 monkeypatch):
    """A delete publishes a view on the ingest stream whose K1 table is
    still being written there, behind a delay kernel, when the flip
    happens; a query launched on the query stream right after the flip
    waits on the view's event and answers from the new view. The control,
    with the wait taken out, reads the unfinished table (the old view's
    rows) and answers as before the delete: the race is real."""
    from repro_torch.core import segments as seg_mod
    svc, corpus = _sched_service(gen)
    idx = svc.index
    q = corpus.index(torch.arange(16, device="cuda"))    # self-queries
    real = fq_mod.segment_table
    ing, qs = torch.cuda.Stream(), torch.cuda.Stream(priority=-(1 << 10))

    def slow_table(segs, caps):
        table = real(segs, caps)
        final = table.desc.clone()
        table.desc.copy_(old_desc)           # what a stale read sees
        torch.cuda._sleep(200_000_000)       # the delay kernel
        table.desc.copy_(final)
        return table

    monkeypatch.setattr(fq_mod, "segment_table", slow_table)
    for wait in (True, False):
        if not wait:
            monkeypatch.setattr(seg_mod.StoreView, "acquire",
                                lambda self: self)
        old_view = idx.store.view
        old_desc = old_view.k1_table.desc
        before = idx.query_batch(q, topk=10)
        torch.cuda.synchronize()
        with torch.cuda.stream(ing):
            idx.delete(list(range(0, 16, 2)))
        with torch.cuda.stream(qs):
            got = idx.query_batch(q, topk=10)       # right after the flip
        torch.cuda.synchronize()
        after = idx.query_batch(q, topk=10)         # the settled new view
        torch.cuda.synchronize()
        assert not torch.equal(after[0], before[0])
        want = after if wait else before            # the control: stale
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)
        del old_view


def test_k1_scratch_is_per_stream(gen):
    """Two threads on two streams query one view whose launches take the
    global scratch: each answers as a single thread does, bit for bit, and
    the view's table holds one scratch buffer per stream."""
    import threading
    from repro_torch.serving.lsh_service import build_service
    dims, n = (6, 6, 6), 6000
    base = _integer_data(gen, "cp", dims, n)
    dup = 3 * fq_mod.MAX_WINDOW // 4
    rows = torch.cat([torch.arange(n, device="cuda"),
                      torch.zeros(dup, dtype=torch.long, device="cuda")])
    svc = build_service(gen, "cp-e2lsh", dims, _repeat(base, rows),
                        num_codes=6, num_tables=4, rank=2, bucket_width=4.0)
    q = _repeat(base, torch.cat([
        torch.zeros(32, dtype=torch.long, device="cuda"),
        torch.randint(1, n, (96,), generator=gen, device="cuda")]))
    before = _scratch_queries()
    want = svc.query_arrays(q, topk=10)
    assert _scratch_queries() > before
    out, errors = {}, []

    def serve(k):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                out[k] = [svc.query_arrays(q, topk=10) for _ in range(6)]
        except Exception as exc:        # reported below
            errors.append(exc)

    threads = [threading.Thread(target=serve, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for k in range(2):
        for got in out[k]:
            for g, w_ in zip(got, want):
                assert (g.view("int32") == w_.view("int32")).all()
    assert len(svc.index.store.view.k1_table.scratch) >= 3


@pytest.mark.parametrize("shards", [None, 3])
def test_chunked_fold_on_card_equals_one_pass(gen, shards):
    """The chunked, throttled compaction on the card (chunks of 1,000 rows,
    a stream sync after each step) gives the one-pass fold's arrays bit
    for bit, and the same answers."""
    # two services from one seed: the same family, corpus and store
    svc, corpus = _sched_service(torch.Generator(device="cuda").manual_seed(
        5), n=5000, shards=shards, bucket_cap=32)
    other, _ = _sched_service(torch.Generator(device="cuda").manual_seed(5),
                              n=5000, shards=shards, bucket_cap=32)
    extra = corpus.index(slice(0, 700))
    for s, chunk in ((svc, 1000), (other, None)):
        s.index.swap_chunk_rows = chunk
        s.insert(extra)
        s.delete(torch.arange(0, 5600, 7))
        s.apply_swap(s.prepare_compact())
    a, b = svc.index.store.base, other.index.store.base
    assert a.cap == b.cap
    va, vb = svc.index.store.view, other.index.store.view
    for x, y in zip(va.tensors(), vb.tensors()):
        if x is va.k1_table.desc:       # K1's table: pointers, not values
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)
    q = _planted(gen, corpus, 5000, 64)
    for g, w_ in zip(svc.query_arrays(q), other.query_arrays(q)):
        assert (g == w_).all()


# ---------------------------------------------------------------------------
# Durability on the card, and brute force a row at a time
# ---------------------------------------------------------------------------


def _durable_service(gen, directory, n=3000, shards=None, **kw):
    """A durable cp-e2lsh service over a dense (n, 6, 6, 6) corpus (the
    WAL logs dense inserts), and the corpus."""
    from repro_torch.core.lsh import make_family
    from repro_torch.serving.durability import DurableLSHService
    dims = (6, 6, 6)
    corpus = torch.randn((n,) + dims, generator=gen, device="cuda")
    fam = make_family(gen, "cp-e2lsh", dims, num_codes=6, num_tables=4,
                      rank=2, bucket_width=4.0, device="cuda")
    svc = DurableLSHService(fam, str(directory), bucket_cap=32,
                            shards=shards, snapshot_every=10 ** 9, **kw)
    return svc.build(corpus), corpus


def _wal_bytes(directory):
    import os
    return [open(os.path.join(directory, n), "rb").read()
            for n in sorted(os.listdir(directory)) if n.startswith("wal_")]


def test_durable_insert_of_a_card_batch_logs_the_host_bytes(gen, tmp_path):
    svc, corpus = _durable_service(gen, tmp_path / "card")
    twin = type(svc)(svc.index.family, str(tmp_path / "host"),
                     bucket_cap=32, snapshot_every=10 ** 9).build(corpus)
    batch = corpus[:200] + 0.1 * torch.randn(
        corpus[:200].shape, generator=gen, device="cuda")
    svc.insert(batch)
    twin.insert(batch.cpu())
    svc.delete(torch.arange(0, 40, 3, device="cuda"))
    twin.delete(list(range(0, 40, 3)))
    svc.close()
    twin.close()
    card, host = _wal_bytes(tmp_path / "card"), _wal_bytes(tmp_path / "host")
    assert len(card) == 1 and card == host
    q = batch[:64]
    for g, w_ in zip(svc.query_arrays(q), twin.query_arrays(q)):
        assert (g == w_).all()


@pytest.mark.parametrize("shards", [None, 2])
def test_durable_recovery_on_card_equals_the_live_service(gen, tmp_path,
                                                           shards):
    from repro_torch.kernels.fused_query import (fused_query_plain,
                                                 fused_query_sharded_plain)
    from repro_torch.serving.durability import DurableLSHService
    svc, corpus = _durable_service(gen, tmp_path, shards=shards)
    for k in range(3):
        svc.insert(corpus[k * 100:(k + 1) * 100] + 0.05)
        svc.delete(torch.arange(k, 300, 7, device="cuda"))
    svc.compact()
    svc.snapshot()
    svc.insert(corpus[:50] - 0.05)
    svc.delete([0, 5, 9])
    svc.close()
    k1 = fused_query_sharded if shards else fused_query
    plain = fused_query_sharded_plain if shards else fused_query_plain
    launches, calls = k1.launches, plain.calls
    rec = DurableLSHService(svc.index.family, str(tmp_path), bucket_cap=32,
                            shards=shards).recover()
    assert rec.last_recovery["records"] == 2
    q = corpus[torch.randint(0, 3000, (128,), generator=gen,
                             device="cuda")] + 0.05
    want = svc.query_arrays(q)
    got = rec.query_arrays(q)
    for g, w_ in zip(got, want):
        assert (g.view("int32") == w_.view("int32")).all()
    assert k1.launches > launches and plain.calls == calls
    va, vb = rec.index.store.view, svc.index.store.view
    for a, b in zip(va.tensors(), vb.tensors()):
        if a is getattr(va.k1_table, "desc", None):   # pointers, not values
            continue
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_scheduler_recovery_is_read_on_the_query_lane(gen, tmp_path):
    """A degraded durable tenant whose memory went ahead of its log (an
    unlogged delete stands in for the lost state) recovers through
    ``recover_namespace()`` on the ingest stream; the next query-lane read
    answers from the restored view (the committed state), not the old
    one."""
    from repro_torch.serving import scheduler as sched_mod
    from repro_torch.serving.durability import FaultInjector, InjectedCrash
    from repro_torch.serving.lsh_service import LSHService
    inj = FaultInjector().crash_at("post_wal_append", after=1)
    svc, corpus = _durable_service(gen, tmp_path, injector=inj)
    q = corpus[:24] + 0.05
    streams = []
    recover = svc.recover
    svc.recover = lambda: (streams.append(
        torch.cuda.current_stream().cuda_stream), recover())[1]
    with sched_mod.ServingScheduler(svc, max_batch=8) as sched:
        qs, ing = sched.streams[svc.device]
        sched.insert(corpus[:100] + 0.01).result(timeout=60)
        with pytest.raises(InjectedCrash):
            sched.delete(list(range(0, 30, 2))).result(timeout=60)
        assert svc.health == "degraded"
        # past the health gate: the committed store, then memory run ahead
        committed = LSHService.query_arrays(svc, q)
        LSHService.delete(svc, list(range(30)))   # not logged
        stale = LSHService.query_arrays(svc, q)
        sched.recover_namespace().result(timeout=120)
        got = [sched.query(q[i]).result(timeout=60) for i in range(24)]
    assert streams == [ing.cuda_stream]
    assert not (stale[0] == committed[0]).all()
    for i, (ids, sc, nc) in enumerate(got):
        assert (ids == committed[0][i]).all() and nc == committed[2][i]
        assert (sc.view("int32") == committed[1][i].view("int32")).all()


@pytest.mark.parametrize("layout", ["cp", "dense"])
def test_brute_force_row_equals_its_batch_row_on_card(gen, layout):
    from repro_torch.core.index import brute_force, brute_force_batch
    from repro_torch.core.projections import densify_batch
    dims = (8, 8, 8)
    corpus = cp_random_data(gen, dims, 4, batch=5000)
    queries = _planted(gen, corpus, 5000, 33)
    if layout == "dense":
        corpus, queries = (as_batch(densify_batch(x).reshape(
            (-1,) + dims)) for x in (corpus, queries))
    ids, scores = brute_force_batch("euclidean", queries, corpus, 10)
    for i in range(33):
        got = brute_force("euclidean", queries.index(i), corpus, 10)
        assert (got[0] == ids[i]).all()
        assert (got[1].view("int32") == scores[i].view("int32")).all()
