"""Port parity: the probe side (K1's plain version and its helpers) against
the reference, on the reference's own intermediates.

Integer stages are held bitwise: given the reference index's keys and its
``StoreView.all_arrays`` (carried over with ``convert.segment_from_numpy``),
the port's sorted tables, probe windows, candidate sets and counts equal
the reference's, ``order_key_bits`` / ``decode_order_key`` round-trip bit
for bit, and ``packed_select`` picks the same (id, score bits).

``fused_query_plain`` against the reference's Pallas ``fused_query``
(interpret mode), both given the reference's raw projections: candidate
counts equal; scores within ``parity.rerank_bound`` (the fp32 rounding
bound of the score expression under two summation orders); ids equal except
where the reference's neighbouring scores lie within twice that bound.
"""

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bridge as tb
from repro.core import DeviceLSHIndex as JaxIndex
from repro.core import projections as jproj
from repro.core import segments as jseg
from repro.kernels import epilogues as jepi
from repro.kernels import fused_query as jfq
from repro_torch import convert
from repro_torch.core import segments as tseg
from repro_torch.kernels import epilogues as tepi
from repro_torch.kernels import parity
from repro_torch.kernels import fused_query as tfq
from repro_torch.kernels.fused_query import fused_query_plain, window_plan
from repro_torch.kernels.ops import stack_cp

N, B, TOPK = 61, 9, 5


@pytest.fixture(scope="module", params=[
    ("cp-e2lsh", "euclidean"), ("cp-srp", "cosine"), ("cp-e2lsh", "cosine"),
    ("cp-srp", "euclidean")], ids=lambda p: "-".join(p))
def case(request):
    kind, metric = request.param
    fam = tb.jax_family(kind)
    corpus, queries = tb.cp_fixture(N, B, seed=11)
    idx = JaxIndex(fam, metric=metric, probe_backend="pallas").build(
        tb.jax_cp(corpus))
    view = idx.store.view
    arrays = view.all_arrays[0]
    seg = convert.segment_from_numpy(
        corpus, np.asarray(arrays[1]), np.asarray(arrays[2]),
        np.asarray(view.base.keys), view.all_caps[0], "cpu")
    tview = tseg.SegmentStore(seg).view
    return dict(kind=kind, metric=metric, fam=fam, idx=idx, view=view,
                corpus=corpus, queries=queries, tview=tview,
                tfam=tb.bridge_family(fam))


def test_store_view_lookups_match(case):
    _, _, _, live, eff, win = case["view"].all_arrays[0]
    t = case["tview"].seg_arrays(0)
    np.testing.assert_array_equal(t.live.numpy(), np.asarray(live))
    np.testing.assert_array_equal(t.eff.numpy(), np.asarray(eff))
    assert win is None and t.win is None


def test_sorted_tables_bitwise(case):
    base = case["view"].base
    keys = torch.from_numpy(np.asarray(base.keys).astype(np.int64))
    seg = tseg.build_segment(keys, tb.torch_cp(case["corpus"]))
    np.testing.assert_array_equal(seg.sorted_keys.numpy(),
                                  np.asarray(base.sorted_keys))
    np.testing.assert_array_equal(seg.perm.numpy(), np.asarray(base.perm))
    assert seg.cap == base.cap
    assert int(tseg._max_run_length(seg.sorted_keys)) == int(
        jseg._max_run_length(base.sorted_keys))


def _ref_keys(case):
    mults = jnp.asarray(case["idx"]._mults)
    return np.asarray(jseg.query_keys(case["fam"], mults,
                                      tb.jax_cp(case["queries"])))


def test_query_keys_match_reference(case):
    """The port's T = 1 query keys equal the reference's except in tables
    holding a boundary code; with T > 1, slot 0 of the (L, T, B) keys is the
    T = 1 key."""
    ref = _ref_keys(case).astype(np.int64)                 # (L, B)
    tq = tb.torch_cp(case["queries"])
    got = tseg.query_keys(case["tfam"], case["idx"]._mults, tq).numpy()
    near = tb.near_tables(case["tfam"], case["queries"]).T
    assert ((got == ref) | near).all()
    assert (got == ref).mean() > 0.5
    wide = tseg.query_keys(case["tfam"], case["idx"]._mults, tq, probes=2)
    assert wide.shape == (got.shape[0], 2, got.shape[1])
    np.testing.assert_array_equal(wide[:, 0].numpy(), got)


def test_probe_windows_and_dedup_bitwise(case):
    _, sk, perm, live, _, _ = case["view"].all_arrays[0]
    cap = case["view"].all_caps[0]
    keys = _ref_keys(case)
    ref_ids, ref_hit = jepi.probe_windows(sk, perm, jnp.asarray(keys), cap,
                                          live)
    ref_cand, ref_valid = jepi.dedup_windows(ref_ids, ref_hit, sk.shape[1])
    t = case["tview"].seg_arrays(0)
    ids, hit = tepi.probe_windows(t.sorted_keys, t.perm,
                                  torch.from_numpy(keys.astype(np.int64)),
                                  cap, t.live)
    cand, valid = tepi.dedup_windows(ids, hit, t.sorted_keys.shape[1])
    np.testing.assert_array_equal(hit.numpy(), np.asarray(ref_hit))
    np.testing.assert_array_equal(
        np.where(hit.numpy(), ids.numpy(), -1),
        np.where(np.asarray(ref_hit), np.asarray(ref_ids), -1))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(ref_cand))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    assert valid.sum() > 0


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_order_key_roundtrip_bitwise(metric):
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    special = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, 1e-38, -3e38],
                       np.float32).view(np.uint32)
    bits = np.concatenate([bits, special])
    finite = np.isfinite(bits.view(np.float32))
    scores = bits.view(np.float32)[finite]
    ref = np.asarray(jepi.order_key_bits(metric, jnp.asarray(scores)))
    got = tepi.order_key_bits(metric, torch.from_numpy(scores))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    back = tepi.decode_order_key(metric, got).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), scores.view(np.uint32))


def test_packed_select_bitwise(case):
    metric = case["metric"]
    rng = np.random.default_rng(4)
    scores = rng.normal(size=(B, 40)).astype(np.float32)
    scores[:, ::7] = scores[:, 1::7][:, :scores[:, ::7].shape[1]]  # ties
    eid = rng.permutation(B * 40).reshape(B, 40).astype(np.int32)
    valid = rng.random((B, 40)) < 0.6
    valid[0] = False                                         # an empty row
    hi, lo = jepi.pack_candidates(metric, jnp.asarray(eid),
                                  jnp.asarray(scores), jnp.asarray(valid))
    ref_ids, ref_sc = jepi.packed_select(metric, TOPK, hi, lo)
    thi, tlo = tepi.pack_candidates(metric, torch.from_numpy(eid),
                                    torch.from_numpy(scores),
                                    torch.from_numpy(valid))
    np.testing.assert_array_equal(thi.numpy(),
                                  np.asarray(hi).astype(np.int64))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo))
    ids, sc = tepi.packed_select(metric, TOPK, thi, tlo)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(sc.numpy().view(np.uint32),
                                  np.asarray(ref_sc).view(np.uint32))


def test_fused_query_plain_vs_reference_kernel(case):
    fam, view, idx = case["fam"], case["view"], case["idx"]
    jq = tb.jax_cp(case["queries"])
    mults = idx._mults
    ref_ids, ref_sc, ref_nc = (np.array(a) for a in jfq.fused_query(
        fam, view.all_arrays, jnp.asarray(mults), jq, metric=case["metric"],
        topk=TOPK, caps=view.all_caps, interpret=True))
    values = torch.from_numpy(np.array(jproj.project_batch(fam.projection,
                                                           jq)))
    tfam = case["tfam"]
    offsets = (tfam.offsets if tfam.offsets is not None
               else torch.zeros(values.shape[1]))
    tq, tq_stacked = stack_cp(tb.torch_cp(case["queries"]))
    seg = case["tview"].seg_arrays(0)
    ids, sc, nc = fused_query_plain(
        values, offsets, torch.from_numpy(mults.astype(np.int64)),
        (tq, tq_stacked), (seg,),
        kind=case["kind"], w=tfam.bucket_width, num_tables=tfam.num_tables,
        num_codes=tfam.num_codes, metric=case["metric"], topk=TOPK,
        caps=view.all_caps)
    np.testing.assert_array_equal(nc.numpy(), ref_nc)
    tol = parity.rerank_bound(case["metric"], tq, seg.corpus,
                              torch.from_numpy(ref_ids),
                              torch.from_numpy(ref_sc))
    same = ids.numpy() == ref_ids
    valid = ref_ids >= 0
    keep = same & valid
    err = np.abs(sc.numpy()[keep] - ref_sc[keep])
    assert (err <= tol.numpy()[keep]).all()
    assert parity.topk_mismatches(ids, sc, torch.from_numpy(ref_ids),
                                  torch.from_numpy(ref_sc), tol) == 0
    assert valid.any()


def test_k1_window_limit_is_stated():
    """K1's shared window has a capacity chosen for occupancy, not for the
    worst case: at the CP serving shape 4096 slots (two 12-warp blocks per
    SM), so L*cap up to 4096 never needs the global scratch, while a larger
    one ([main]'s 7650, the example's K = 8 over 2^20 items: cap about
    2950) keeps the same capacity and the launch carries the scratch; a
    small L*cap gets a window of pow2(L*cap); rows that no block holds even
    beside the smallest window raise, naming the limit."""
    assert window_plan(10, 409, 3, 12, 3, 4) == (4096, False)
    assert window_plan(10, 765, 3, 12, 3, 4) == (4096, True)
    assert window_plan(10, 1600, 3, 12, 4, 4) == (4096, True)
    assert window_plan(4, 3, 3, 4, 3, 3) == (16, False)
    assert window_plan(10, 2000, 3, 12, 4, 4) == (4096, True)
    assert window_plan(10, 2952, 3, 12, 4, 3) == (4096, True)
    with pytest.raises(ValueError, match="232448 B"):
        window_plan(10, 4, 4, 64, 32, 32)


def _table_with_scratch():
    return tfq.SegmentTable(desc=torch.zeros((1, tfq.TABLE_COLS),
                                             dtype=torch.int64),
                            segs=(), caps=(8,), layout="cp", n_modes=3, d=4,
                            rc=2)


@pytest.mark.parametrize("plans", [
    ((4, 64), (4, 16)),            # a smaller stride (T falls)
    ((4, 64), (2, 64), (4, 32)),   # a smaller batch, then a smaller stride
    ((2, 16), (1, 64), (8, 64)),   # a larger stride, then a larger batch
    ((3, 32), (3, 32), (2, 32)),   # the same stride
])
def test_k1_scratch_rows_empty_at_every_stride(plans):
    """K1's global scratch is laid out per launch at a row stride of
    3 * scap (a hash set of 2 * scap, then a candidate list), and the kernel
    leaves its hash sets empty and its lists full of ids. Whatever launches
    came before, every row's hash set at the new stride is empty; a buffer
    of the same stride and size is reused as it is."""
    table = _table_with_scratch()
    prev = None
    for b, scap in plans:
        slots = tfq.scratch_rows(table, b, scap, torch.device("cpu"))
        assert slots.numel() >= b * 3 * scap
        rows = slots[:b * 3 * scap].view(b, 3 * scap)
        assert bool((rows[:, :2 * scap] == -1).all())
        if prev is not None and prev[1] == scap and prev[0].numel() >= (
                b * 3 * scap):
            assert slots is prev[0] and bool((rows[:, 2 * scap:] >= 0).all())
        # what a launch leaves: empty sets, candidate lists of ids
        rows[:, 2 * scap:] = torch.arange(scap, dtype=torch.int32)
        prev = (slots, scap)


def test_k1_branch_counts_read_the_card_count():
    """``fused_query.branches``: launches by branch on the host, and the
    queries that took the scratch counted on the device; reading "scratch"
    folds the device count in (and zeroes it), ``clear`` drops both."""
    counts = tfq.BranchCounts()
    counter = counts.counter(torch.device("cpu"))
    assert counts.counter(torch.device("cpu")) is counter
    counts.update(["multiprobe", "segments", "multiprobe"])
    counter += 5
    assert counts["scratch"] == 5 and int(counter) == 0
    counter += 2
    assert counts["multiprobe"] == 2 and counts["scratch"] == 7
    counter += 3
    counts.clear()
    assert counts["scratch"] == 0 and counts["multiprobe"] == 0
    assert int(counter) == 0
    assert isinstance(tfq.fused_query.branches, tfq.BranchCounts)
    assert isinstance(tfq.fused_query_sharded.branches, tfq.BranchCounts)

