"""Port parity: the sampling query modes ("uniform", "weighted") of K1 and
K1s's plain versions, the indexes and the service, against the reference's
``segmented_sample`` / ``_sample_topk`` (``repro.core.segments``).

The two packages draw from different generators (a JAX PRNG key there, a
``torch.Generator`` here, whose two key words seed a counter-based hash of
(query row, effective id)), so the deterministic parts are held bit for bit
and the draw by statistics:

* on reference stores carried across (``torch_bridge.carry_store``: one
  segment and a dense window, or tombstones, a delta segment and the
  ``bucket_cap`` live window), given the reference's raw projections, at T
  in {1, 4, 8}: each query's probed union and every member's raw hit count
  (``fused_query.sample_union``) equal the reference's run lengths of
  ``_segment_scored_hits``, the pad regime's repeated base keys included;
  ``n_cand`` equals the reference ``segmented_sample``'s and the port's own
  top-k path's; sampled ids are distinct members of the union, as many as
  ``min(topk, |union|)``, the whole union for a large ``topk``; their
  scores match the reference's exact scores within ``parity.rerank_bound``;
* ``shards=3`` draws the same ids as the single index from the same
  generator seed, a seed replays its draw and another seed differs, and CP,
  TT and dense query batches are sampled over one corpus;
* the twins of ``tests/test_multiprobe.py``'s ``TestSamplingStatistics``
  (one query replicated over 2048 rows, ``topk=1``, the chi-square bound
  2 df + 6 sqrt(2 df) + 20 against the reference host index's window
  counts) and ``TestModeContracts``, for the index and the service.
"""

import collections

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grids
import torch_bridge as tb
from repro.core import DeviceLSHIndex as JaxIndex
from repro.core import HostLSHIndex as JaxHost
from repro.core import make_family as jax_make_family
from repro.core import probing as jprobing
from repro.core import projections as jproj
from repro.core import segments as jseg
from repro_torch.core.tensor_formats import DenseTensor, cp_to_tt
from repro_torch.core.index import DeviceLSHIndex, ShardedLSHIndex
from repro_torch.core.projections import densify_batch
from repro_torch.kernels import parity
from repro_torch.kernels.fused_query import (fused_query_plain,
                                             sample_union)
from repro_torch.serving.lsh_service import LSHService, build_service

N, B, TOPK = 53, 6, 5
MODES = ("uniform", "weighted")
# the reference's raw scored window hits of one segment, compiled once per
# (metric, cap) and shape rather than run op by op
_scored_hits = jax.jit(jseg._segment_scored_hits, static_argnums=(0, 1))


def _fmt(kind):
    tt = kind.startswith("tt-")
    return ((tb.tt_fixture, tb.jax_tt, tb.torch_tt) if tt
            else (tb.cp_fixture, tb.jax_cp, tb.torch_cp))


@pytest.fixture(scope="module", params=[
    ("cp-e2lsh", "euclidean", "fresh", None),
    ("cp-e2lsh", "euclidean", "mutated", 4),
    ("tt-srp", "cosine", "mutated", 4),
    ("pad", "cosine", "fresh", None)], ids=lambda p: "-".join(map(str, p)))
def case(request):
    """A reference store carried across. "pad": a cp-srp family of K = 2,
    whose expansion has 3 candidates, so T = 8 repeats the base key in 4
    probe slots of every table (the pad regime)."""
    kind, metric, state, cap = request.param
    if kind == "pad":
        kind = "cp-srp"
        fam = jax_make_family(jax.random.PRNGKey(3), kind, tb.DIMS,
                              num_codes=2, num_tables=3, rank=2,
                              bucket_width=1.0, hash_backend="xla")
        assert jprobing.expansion_size(kind, 2) == 3
    else:
        fam = tb.jax_family(kind, backend="xla")
    fixture, jwrap, twrap = _fmt(kind)
    corpus, queries = fixture(N, B, seed=31)
    idx = JaxIndex(fam, metric=metric, bucket_cap=cap,
                   probe_backend="xla").build(jwrap(corpus))
    if state == "mutated":
        idx.delete(jnp.arange(0, 12, 3))
        idx.insert(jwrap([f[:7] * (1.01 if i == 0 else 1.0)
                          for i, f in enumerate(corpus)]))
    tfam = tb.bridge_family(fam)
    tidx = DeviceLSHIndex(tfam, metric=metric, bucket_cap=cap)
    tidx.store = tb.carry_store(idx.store)
    values = torch.from_numpy(np.array(jproj.project_batch(fam.projection,
                                                           jwrap(queries))))
    return dict(kind=kind, metric=metric, state=state, fam=fam, idx=idx,
                tfam=tfam, tidx=tidx, jq=jwrap(queries), tq=twrap(queries),
                values=values, refs={})


def _plain_kw(case, probes):
    tfam, view = case["tfam"], case["tidx"].store.view
    return dict(kind=tfam.kind, w=tfam.bucket_width,
                num_tables=tfam.num_tables, num_codes=tfam.num_codes,
                caps=view.all_caps, probes=probes)


def _args(case):
    return (case["values"], case["tfam"].offsets,
            torch.from_numpy(case["idx"]._mults.astype(np.int64)))


def _reference_hits(case, probes):
    """The reference's raw scored window hits over every segment -> per row
    ({eid: raw hit count}, {eid: exact score})."""
    if probes not in case["refs"]:
        idx, view = case["idx"], case["idx"].store.view
        keys = jseg.query_keys(case["fam"], jnp.asarray(idx._mults),
                               case["jq"], probes)
        eids, scores = [], []
        for i, cap in enumerate(view.all_caps):
            eid, sc = _scored_hits(case["metric"], cap, case["jq"],
                                   view.seg_arrays(i), keys)
            eids.append(np.asarray(eid))
            scores.append(np.asarray(sc))
        eid, sc = np.concatenate(eids, 1), np.concatenate(scores, 1)
        rows = []
        for r in range(eid.shape[0]):
            hit = eid[r] != jseg._NO_ID
            rows.append((dict(collections.Counter(eid[r][hit].tolist())),
                         dict(zip(eid[r][hit].tolist(), sc[r][hit].tolist()))))
        case["refs"][probes] = rows
    return case["refs"][probes]


@pytest.mark.parametrize("probes", [1, 4, 8])
def test_union_and_multiplicities_equal_reference(case, probes):
    """Each query's probed union and its members' raw hit counts, id for
    id, against the reference's run lengths (pad-regime repeats counted)."""
    ref = _reference_hits(case, probes)
    eff, mult, valid = sample_union(*_args(case)[:2], _args(case)[2],
                                    case["tidx"].store.view.all_arrays,
                                    **_plain_kw(case, probes))
    for r, (want, _) in enumerate(ref):
        got = {int(e): int(m) for e, m, v in zip(eff[r], mult[r], valid[r])
               if v}
        assert got == want, (case["kind"], probes, r)
    assert sum(len(w) for w, _ in ref) > 0
    if case["kind"] == "cp-srp" and probes == 8:   # the pad regime
        assert max(max(w.values(), default=0) for w, _ in ref) >= 4


@pytest.mark.parametrize("probes", [1, 4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_sample_counts_members_and_scores(case, probes, mode):
    ref = _reference_hits(case, probes)
    view = case["tidx"].store.view
    kw = _plain_kw(case, probes)
    ids, sc, nc = fused_query_plain(*_args(case), case["tq"].stack(),
                                    view.all_arrays, metric=case["metric"],
                                    topk=TOPK, mode=mode, key=(7, 11), **kw)
    _, _, t_nc = fused_query_plain(*_args(case), case["tq"].stack(),
                                   view.all_arrays, metric=case["metric"],
                                   topk=TOPK, **kw)
    np.testing.assert_array_equal(nc.numpy(), t_nc.numpy())
    np.testing.assert_array_equal(nc.numpy(), [len(w) for w, _ in ref])
    corpus = case["tidx"].effective_corpus()
    tol = parity.rerank_bound(case["metric"], case["tq"], corpus, ids, sc)
    for r, (want, scores) in enumerate(ref):
        row = ids[r].numpy()
        drawn = row[row >= 0].tolist()
        assert len(drawn) == min(TOPK, len(want)) == len(set(drawn))
        assert set(drawn) <= set(want)
        assert (row[len(drawn):] == -1).all()
        for k, e in enumerate(drawn):
            assert abs(float(sc[r, k]) - scores[e]) <= float(tol[r, k])
        # in the top-k path's order: ascending distance / descending
        # similarity
        s = sc[r, :len(drawn)].numpy()
        assert (np.diff(s) >= 0).all() if case["metric"] == "euclidean" \
            else (np.diff(s) <= 0).all()
    # a topk at least as large as the union returns the whole union
    big, _, _ = fused_query_plain(*_args(case), case["tq"].stack(),
                                  view.all_arrays, metric=case["metric"],
                                  topk=N + 8, mode=mode, key=(7, 11), **kw)
    for r, (want, _) in enumerate(ref):
        row = big[r].numpy()
        assert set(row[row >= 0].tolist()) == set(want)
    assert (big.numpy() < case["tidx"].size).all()   # live ids only


@pytest.mark.parametrize("mode", MODES)
def test_n_cand_equals_reference_segmented_sample(case, mode):
    idx, view = case["idx"], case["idx"].store.view
    _, _, ref_nc = jseg.segmented_sample(
        case["fam"], view.all_arrays, jnp.asarray(idx._mults), case["jq"],
        jax.random.PRNGKey(5), metric=case["metric"], topk=TOPK,
        caps=view.all_caps, probes=8, mode=mode)
    _, _, nc = fused_query_plain(*_args(case), case["tq"].stack(),
                                 case["tidx"].store.view.all_arrays,
                                 metric=case["metric"], topk=TOPK, mode=mode,
                                 key=(1, 2), **_plain_kw(case, 8))
    np.testing.assert_array_equal(nc.numpy(), np.asarray(ref_nc))


@pytest.fixture(scope="module")
def built():
    """The port's own indexes over one CP corpus: single and shards=3,
    fresh, then one delete and insert each."""
    corpus, queries = tb.cp_fixture(61, 8, seed=41)
    fam = tb.bridge_family(tb.jax_family("cp-e2lsh"))
    single = DeviceLSHIndex(fam, metric="euclidean")
    sharded = ShardedLSHIndex(fam, metric="euclidean", shards=3)
    for index in (single, sharded):
        index.build(tb.torch_cp(corpus))
    return dict(fam=fam, single=single, sharded=sharded, corpus=corpus,
                q=tb.torch_cp(queries))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("state", ["fresh", "mutated"])
def test_shards_draw_the_single_index_sample(built, mode, state):
    if state == "mutated" and built["single"].size == 61:
        for index in (built["single"], built["sharded"]):
            index.delete(np.array([2, 9, 30]))
            index.insert(tb.torch_cp([f[:5] * 1.02 for f in built["corpus"]]))
    q = built["q"]
    a = built["single"].query_batch(q, topk=TOPK, probes=4, mode=mode,
                                    rng=_gen(13))
    b = built["sharded"].query_batch(q, topk=TOPK, probes=4, mode=mode,
                                     rng=_gen(13))
    np.testing.assert_array_equal(b[0].numpy(), a[0].numpy())
    np.testing.assert_array_equal(b[2].numpy(), a[2].numpy())
    tol = parity.rerank_bound("euclidean", q,
                              built["single"].effective_corpus(), a[0], a[1])
    assert ((b[1] - a[1]).abs() <= tol).all()
    assert (a[0] >= 0).any()


@pytest.mark.parametrize("mode", MODES)
def test_seed_replays_and_another_seed_differs(built, mode):
    index, q = built["single"], built["q"]
    a = index.query_batch(q, topk=TOPK, probes=4, mode=mode, rng=_gen(23))
    b = index.query_batch(q, topk=TOPK, probes=4, mode=mode, rng=_gen(23))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    rep = q.index(torch.zeros(64, dtype=torch.long))
    c = index.query_batch(rep, topk=1, probes=4, mode=mode, rng=_gen(23))
    d = index.query_batch(rep, topk=1, probes=4, mode=mode, rng=_gen(24))
    assert not torch.equal(c[0], d[0])
    assert len(set(c[0][:, 0].tolist())) > 1     # rows draw independently


@pytest.mark.parametrize("mode", MODES)
def test_every_query_format_is_sampled(built, mode):
    """CP, TT and dense batches of the same queries over the CP corpus:
    each draw lies in that batch's own union, with the top-k path's count
    and the exact scores of the brute-force matrix."""
    index, fam = built["single"], built["fam"]
    view = index.store.view
    cp = built["q"]
    dense = densify_batch(cp).reshape((-1,) + tuple(cp.dims))
    for q in (cp, cp_to_tt(cp), DenseTensor(dense, cp.dims)):
        ids, sc, nc = index.query_batch(q, topk=TOPK, probes=4, mode=mode,
                                        rng=_gen(3))
        _, _, t_nc = index.query_batch(q, topk=TOPK, probes=4)
        np.testing.assert_array_equal(nc.numpy(), t_nc.numpy())
        x, stacked = q.stack()
        eff, _, valid = sample_union(
            fam.raw_stacked(stacked, x.scale), fam.offsets,
            index._mults_t, view.all_arrays, kind=fam.kind,
            w=fam.bucket_width, num_tables=fam.num_tables,
            num_codes=fam.num_codes, caps=view.all_caps, probes=4)
        corpus = index.effective_corpus()
        tol = parity.rerank_bound("euclidean", q, corpus, ids, sc)
        for r in range(ids.shape[0]):
            union = set(eff[r][valid[r]].tolist())
            row = ids[r][ids[r] >= 0].tolist()
            assert len(row) == min(TOPK, len(union)) == len(set(row))
            assert set(row) <= union, (q.layout, r)
        from repro_torch.core.index import _score_matrix
        exact = _score_matrix("euclidean", q, corpus)
        ok = ids >= 0
        want = exact.gather(1, torch.where(ok, ids, 0).long())
        assert ((sc - want).abs()[ok] <= tol[ok]).all(), q.layout


# ---------------------------------------------------------------------------
# The twins of tests/test_multiprobe.py's statistics and contracts
# ---------------------------------------------------------------------------


def _host_union_and_weights(host, x, probes):
    """test_multiprobe.py's counting: every (table, probe slot) window
    ticket of the reference's host index, pad repeats included."""
    keys = np.asarray(jprobing.probe_keys(
        host.family, jnp.asarray(host._mults),
        jax.tree.map(lambda a: a[None], x), probes=int(probes)))
    weights = {}
    for t in range(host.family.num_tables):
        for key in keys[0, t]:
            for member in host._tables[t].get(int(key), ()):
                weights[member] = weights.get(member, 0) + 1
    return set(weights), weights


class TestSamplingStatistics:
    B = 2048
    PROBES = 8

    @pytest.fixture(scope="class", params=["e2lsh", "tt-srp"])
    def stats_case(self, request):
        kind = request.param
        corpus, queries = grids.corpus_and_queries(67, 4)
        fam = grids.grid_family(kind)
        metric = grids.metric_for(kind)
        host = JaxHost(fam, metric=metric).build(corpus)
        union, weights = _host_union_and_weights(host, queries[1],
                                                 self.PROBES)
        assert len(union) >= 5, "fixture bucket structure collapsed"
        index = DeviceLSHIndex(tb.bridge_family(fam), metric=metric)
        index.build(torch.from_numpy(np.asarray(corpus)))
        x = torch.from_numpy(np.asarray(queries[1]))
        batch = x[None].expand((self.B,) + x.shape).contiguous()
        return dict(kind=kind, index=index, batch=batch, union=union,
                    weights=weights, draws={})

    def _freqs(self, case, mode, seed):
        if (mode, seed) not in case["draws"]:
            ids, _, _ = case["index"].query_batch(
                case["batch"], topk=1, probes=self.PROBES, mode=mode,
                rng=_gen(seed))
            drawn = ids[:, 0].numpy()
            assert (drawn >= 0).all()
            counts = {m: int((drawn == m).sum()) for m in case["union"]}
            assert sum(counts.values()) == self.B   # every draw a member
            case["draws"][mode, seed] = counts
        return case["draws"][mode, seed]

    @staticmethod
    def _chi2(counts, expected):
        return sum((counts[m] - e) ** 2 / e for m, e in expected.items())

    @staticmethod
    def _bound(df):
        return 2 * df + 6 * (2 * df) ** 0.5 + 20

    def test_uniform_frequencies(self, stats_case):
        counts = self._freqs(stats_case, "uniform", 101)
        union = stats_case["union"]
        expected = {m: self.B / len(union) for m in union}
        assert self._chi2(counts, expected) < self._bound(len(union) - 1)

    def test_weighted_frequencies(self, stats_case):
        counts = self._freqs(stats_case, "weighted", 202)
        weights = stats_case["weights"]
        total = sum(weights.values())
        expected = {m: self.B * w / total for m, w in weights.items()}
        assert max(weights.values()) > min(weights.values())
        assert self._chi2(counts, expected) < self._bound(len(weights) - 1)

    def test_weighted_differs_from_uniform(self, stats_case):
        counts = self._freqs(stats_case, "weighted", 202)
        union = stats_case["union"]
        uniform = {m: self.B / len(union) for m in union}
        assert self._chi2(counts, uniform) > self._bound(len(union) - 1)


class TestModeContracts:
    @pytest.fixture(scope="class")
    def index(self):
        corpus, queries = grids.corpus_and_queries(67, 4)
        index = DeviceLSHIndex(tb.bridge_family(grids.grid_family("e2lsh")),
                               metric="euclidean")
        index.build(torch.from_numpy(np.asarray(corpus)))
        return index, torch.from_numpy(np.asarray(queries))

    def test_unknown_mode_rejected(self, index):
        idx, q = index
        with pytest.raises(ValueError, match="unknown query mode"):
            idx.query_batch(q, mode="nearest")

    def test_topk_mode_rejects_rng(self, index):
        idx, q = index
        with pytest.raises(ValueError, match="sampling modes only"):
            idx.query_batch(q, mode="topk", rng=_gen(0))

    @pytest.mark.parametrize("mode", MODES)
    def test_sampling_requires_rng(self, index, mode):
        idx, q = index
        with pytest.raises(ValueError, match="Generator"):
            idx.query_batch(q, mode=mode)

    def test_service_contracts_and_stats(self, index):
        idx, q = index
        fam = idx.family
        with pytest.raises(ValueError, match="probes"):
            LSHService(fam, probes=0)
        with pytest.raises(ValueError, match="query_mode"):
            LSHService(fam, query_mode="nearest")
        corpus = idx.effective_corpus().data
        svc = LSHService(fam, metric="euclidean").build(corpus)
        with pytest.raises(ValueError, match="seed"):
            svc.query_arrays(q, mode="uniform")         # no seed
        with pytest.raises(ValueError, match="seed"):
            svc.query_arrays(q, mode="topk", seed=1)    # spurious seed
        with pytest.raises(ValueError, match="unknown query mode"):
            svc.query_arrays(q, mode="nearest")
        for probes in (0, -1):
            with pytest.raises(ValueError, match="probes must be >= 1"):
                svc.query_arrays(q, probes=probes)
        for topk in (0, -5):
            with pytest.raises(ValueError, match="topk must be >= 1"):
                svc.query_arrays(q, topk=topk)
        svc.query_arrays(q)
        a = svc.query_arrays(q, mode="uniform", seed=9)
        b = svc.query_arrays(q, mode="uniform", seed=9)
        svc.query_arrays(q, mode="weighted", seed=9, probes=2)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        st = svc.stats
        assert (st.topk_queries, st.uniform_queries,
                st.weighted_queries) == (4, 8, 4)
        assert st.topk_queries + st.uniform_queries + st.weighted_queries \
            == st.queries == 16
        st.reset()
        assert (st.queries, st.uniform_queries, st.weighted_queries) == (
            0, 0, 0)

    @pytest.mark.parametrize("shards", [None, 2])
    def test_service_query_mode_default(self, index, shards):
        """``query_mode`` sets the default mode; the single index and
        ``shards=S`` answer alike."""
        idx, q = index
        svc = build_service(None, "e2lsh", grids.DIMS,
                            idx.effective_corpus().data, num_codes=3,
                            num_tables=4, device="cpu", family=idx.family,
                            shards=shards, query_mode="weighted")
        with pytest.raises(ValueError, match="seed"):
            svc.query_arrays(q)
        ids, _, n_cand = svc.query_arrays(q, topk=3, seed=4)
        want = idx.query_batch(q, topk=3, mode="weighted", rng=_gen(4))
        np.testing.assert_array_equal(ids, want[0].numpy())
        np.testing.assert_array_equal(n_cand, want[2].numpy())
        assert svc.stats.weighted_queries == 4


# ---------------------------------------------------------------------------
# The sampling launch's plan (the card's C launch refuses another)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,q_layout,rq,rc,n,d", [
    ("cp", "cp", 4, 4, 3, 12), ("tt", "tt", 4, 4, 4, 16),
    ("dense", "dense", 1, 1, 1, 1728), ("cp", "tt", 8, 4, 3, 12)])
def test_sample_plan_takes_six_words_a_slot(layout, q_layout, rq, rc, n, d):
    """A sampling launch's block: 3 more words a window slot (the set's
    counts, the list's counts) and 4 more bytes a list rank (the score
    keys); where the target blocks still fit, its window is at most the
    top-k launch's, and where they no longer fit (TT <4, 4>), the plan
    takes one block fewer (``plan_blocks``) and a larger window."""
    from repro_torch.kernels import fused_query as fq
    kw = dict(tt=layout == "tt", dense=layout == "dense", topk=10,
              q_layout=q_layout, df=1728 if "dense" in (layout, q_layout)
              and layout != q_layout else 0)
    tr, qr = fq.instance(layout, q_layout, rq, rc, n, d)
    nwarps = fq.SHAPES[tr, qr][0] // 32
    for window in (256, 1024, 4096):
        grow = (fq.smem_bytes(10, n, d, rq, rc, window, sample=True, **kw)
                - fq.smem_bytes(10, n, d, rq, rc, window, **kw))
        assert grow == 3 * window * 4 + (nwarps + 1) * 10 * 4
    top, _ = fq.window_plan(10, 440, n, d, rq, rc, **kw)
    sample, _ = fq.window_plan(10, 440, n, d, rq, rc, sample=True, **kw)
    smem = fq.smem_bytes(10, n, d, rq, rc, sample, sample=True, **kw)
    target = fq.SHAPES[tr, qr][1]
    blocks = fq.plan_blocks(smem, target)
    assert fq.plan_blocks(fq.smem_bytes(10, n, d, rq, rc, top, **kw),
                          target) == target
    if (tr, qr) == (4, 4):
        # no window fits 3 blocks: [tt-main]'s sampling launch runs 2, with
        # a window of 1,024 slots beside the top-k launch's 256
        assert (blocks, top, sample) == (target - 1, 256, 1024)
    else:
        assert blocks == target and sample <= top


def test_scratch_rows_relayout_between_modes():
    """A view's scratch rows at 3 words a slot (top-k) and 6 (sampling):
    a buffer laid out for the other mode or another scap is emptied before
    it is reused, one of the same layout is reused as it is."""
    from repro_torch.kernels import fused_query as fq
    table = fq.SegmentTable(desc=torch.zeros(1, 12), segs=(), caps=(8,),
                            layout="cp", n_modes=1, d=1, rc=1)
    a = fq.scratch_rows(table, 4, 16, "cpu")
    assert a.numel() == 4 * 3 * 16 and bool((a == -1).all())
    a[:8] = 5                       # a list the kernel left behind
    assert fq.scratch_rows(table, 4, 16, "cpu").data_ptr() == a.data_ptr()
    assert int(a[0]) == 5           # same layout: reused as it is
    b = fq.scratch_rows(table, 4, 16, "cpu", words=fq.SAMPLE_WORDS)
    assert b.numel() == 4 * 6 * 16 and bool((b == -1).all())
    b[:8] = 5
    c = fq.scratch_rows(table, 4, 16, "cpu")
    assert c.data_ptr() == b.data_ptr() and bool((c == -1).all())
    assert fq.stream_scratch(table, "cpu")["layout"] == (3, 16)
