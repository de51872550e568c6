"""Port parity: the serving scheduler (``repro_torch.serving.scheduler``),
the chunked, throttled shadow build and the serving-plane state of
``LSHService``, against the reference's (``repro.serving``) on the same
inputs: ``grids``' dense fixture and the reference's cp-e2lsh grid family,
carried across by ``torch_bridge.bridge_family``, services on the CPU.

* Coalescing: scheduled rows equal the direct batch's bit for bit, and the
  reference scheduler's rows within the parity contract (candidate counts
  equal on equal keys, ids equal except at near ties, scores within
  ``parity.rerank_bound``); sampling requests replay by seed and never
  coalesce; errors resolve futures without wedging a lane; the ingest lane
  orders mutations and swaps; ``flush`` / ``close``.
* Namespaces: tenants route to their own index, ``max_items`` and
  ``max_pending`` quotas refuse and count.
* Swaps: queries racing a ``prepare_compact`` / ``prepare_rebalance`` and
  its publish, directly and through the scheduler, answer from the pre- or
  the post-swap store, never a mixture; a stale swap is refused.
* The chunked fold (``swap_chunk_rows``) is bit-equal to the one-pass fold
  on every array at S in {None, 2}, and to the reference's chunked fold of
  the same carried store.
* Robustness without a WAL: a service subclass fires a ``FaultInjector``
  in ``insert`` on both sides; retries, errors, ``last_error``, health,
  shed counts and ``RequestTimeout`` match the reference's.
* Robustness with the WAL (``durability.DurableLSHService``, the
  reference's ``TestDegradedServing``): transient WAL failures retry and
  commit one record; exhausted retries and an injected ``post_wal_append``
  crash degrade the tenant, which sheds until ``recover_namespace()``
  replays it back to "serving" on the ingest lane, bit for bit the
  committed prefix of a plain service.

The reference's services compile a few programs (builds, one insert and
the scheduled batch shapes of ``test_coalesced_rows_match_direct_and_
reference``; ROADMAP.md R3).
"""

import functools
import threading
import time

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import grids
import torch_bridge as tb
from repro.serving import durability as jdur
from repro.serving import scheduler as jsched
from repro.serving.lsh_service import LSHService as JaxService
from repro_torch.core import segments as tseg
from repro_torch.core.tensor_formats import as_batch, stack_items
from repro_torch.kernels import parity
from repro_torch.serving import durability as tdur
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.lsh_service import LSHService

TOPK = 5
N_CORPUS = 67          # coprime to the shard counts: a padded last shard
N_QUERIES = 6
N_INS = 13
LAYOUTS = (None, 2)


@functools.lru_cache(maxsize=None)
def _family():
    return grids.grid_family("cp-e2lsh")


@functools.lru_cache(maxsize=None)
def _data():
    corpus, queries = grids.corpus_and_queries(N_CORPUS, N_QUERIES)
    return np.array(corpus), np.array(queries)


def _service(shards, cls=LSHService, **kw):
    corpus, _ = _data()
    kw.setdefault("bucket_cap", 16)
    kw.setdefault("max_deltas", 64)       # no auto-compact under the races
    return cls(tb.bridge_family(_family()), metric="euclidean",
               shards=shards, **kw).build(torch.from_numpy(corpus))


def _ref_service(shards, cls=JaxService, **kw):
    corpus, _ = _data()
    kw.setdefault("bucket_cap", 16)
    kw.setdefault("max_deltas", 64)
    return cls(_family(), metric="euclidean", shards=shards,
               **kw).build(corpus)


def _mutate(svc, wrap=torch.from_numpy):
    """One delta slab + tombstones in both base and delta, so the fold
    has real compaction work (not a no-op flip)."""
    corpus, _ = _data()
    svc.insert(wrap(corpus[:N_INS] + 0.5))
    svc.delete([3, 10, 25, N_CORPUS + 2])


def _queries():
    return torch.from_numpy(_data()[1])


def _answers(svc):
    return svc.query_arrays(_queries(), topk=TOPK)


def _rows(got):
    """Scheduled results (one (ids, scores, n) a request) -> arrays."""
    return (np.stack([g[0] for g in got]), np.stack([g[1] for g in got]),
            np.array([g[2] for g in got]))


def _matches(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def _assert_same(a, b):
    for name, x, y in zip(("ids", "scores", "n_cand"), a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


def _assert_parity(got, ref, svc):
    """The port's rows against the reference's: counts equal (the keys
    are equal, ``test_coalesced_rows_match_direct_and_reference``), ids
    equal except at near ties, scores within the rounding bound."""
    ids, sc, nc = (np.asarray(a) for a in got)
    ri, rs, rn = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(nc, rn)
    tol = parity.rerank_bound("euclidean", as_batch(_queries()),
                              svc.index.effective_corpus(),
                              torch.from_numpy(ri), torch.from_numpy(rs))
    keep = (ids == ri) & (ri >= 0)
    assert (np.abs(sc[keep] - rs[keep]) <= tol.numpy()[keep]).all()
    assert parity.topk_mismatches(torch.from_numpy(ids),
                                  torch.from_numpy(sc),
                                  torch.from_numpy(ri), torch.from_numpy(rs),
                                  tol) == 0
    assert (ri >= 0).any()


def _schedule(sched, **kw):
    futs = [sched.query(q, topk=TOPK, **kw) for q in _queries()]
    return _rows([f.result(timeout=30) for f in futs])


# ---------------------------------------------------------------------------
# Coalescing and the lanes (tests/test_serving.py's TestSchedulerCoalescing)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", LAYOUTS)
def test_coalesced_rows_match_direct_and_reference(shards):
    svc = _service(shards)
    ref = _ref_service(shards)
    # the two hashes agree on every key of this fixture (no code lies at a
    # bucket edge), so counts compare exactly below
    np.testing.assert_array_equal(
        svc.index.store.base.keys.reshape(-1, 4).numpy(),
        np.asarray(ref.index.store.base.keys).reshape(-1, 4).astype(np.int64))
    direct = _answers(svc)
    with tsched.ServingScheduler(svc, max_batch=3,
                                 deadline_ms=100.0) as sched:
        got = _schedule(sched)
    _assert_same(got, direct)
    assert sched.stats.requests == N_QUERIES
    assert sched.stats.batches == 2 and sched.stats.size_flushes == 2
    assert sched.stats.mean_batch == N_QUERIES / 2
    assert svc.stats.queries == 2 * N_QUERIES      # direct + scheduled
    assert svc.stats.batches == 3
    if shards is None:      # the reference scheduler's own rows (R3)
        with jsched.ServingScheduler(ref, max_batch=3,
                                     deadline_ms=100.0) as rsched:
            rfuts = [rsched.query(q, topk=TOPK) for q in _data()[1]]
            want = _rows([f.result(timeout=60) for f in rfuts])
        assert rsched.stats.requests == sched.stats.requests
        assert rsched.stats.batches == sched.stats.batches
        _assert_parity(got, want, svc)
    else:
        _assert_parity(got, ref.query_arrays(_data()[1], topk=TOPK), svc)


def test_stack_items_matches_batch():
    corpus, _ = _data()
    items = [torch.from_numpy(c) for c in corpus[:3]]
    batch = stack_items(items)
    assert batch.dims == (4, 4, 4) and torch.equal(
        batch.data, torch.from_numpy(corpus[:3]))
    cp = tb.torch_cp([np.ones((3, 4, 2), np.float32)] * 3, scale=2.0)
    back = stack_items([cp.index(i) for i in range(3)])
    assert back.scale == 2.0 and all(
        torch.equal(a, b) for a, b in zip(back.leaves, cp.leaves))
    with pytest.raises(ValueError, match="scales"):
        stack_items([cp.index(0), tb.torch_cp([np.ones((4, 2),
                                                       np.float32)] * 3)])


def test_sampling_requests_replay_by_seed_and_never_coalesce():
    svc = _service(None)
    q = _queries()[0]
    with tsched.ServingScheduler(svc, max_batch=8, deadline_ms=50.0) as sched:
        futs = [sched.query(q, topk=TOPK, mode="uniform", seed=9)
                for _ in range(4)]
        got = [f.result(timeout=30) for f in futs]
        sched.flush(timeout=30)
        # one batch per sampling request: the draw is a per-request seeded
        # event, never amortized across requests
        assert sched.stats.batches == 4
    for r in got[1:]:
        _assert_same(r, got[0])
    direct = svc.query_arrays(_queries()[:1], topk=TOPK, mode="uniform",
                              seed=9)
    _assert_same(got[0], (direct[0][0], direct[1][0], int(direct[2][0])))
    assert svc.stats.uniform_queries == 5


def test_errors_resolve_futures_without_wedging_the_lane():
    svc = _service(None)
    q = _queries()[0]
    with tsched.ServingScheduler(svc, max_batch=4, deadline_ms=5.0) as sched:
        with pytest.raises(ValueError, match="probes must be >= 1"):
            sched.query(q, probes=0).result(timeout=30)
        with pytest.raises(ValueError, match="seed"):
            sched.query(q, mode="uniform").result(timeout=30)
        # an item the query path cannot run (the wrong mode dims) fails
        # inside the lane; its future carries the error
        with pytest.raises(Exception):
            sched.query(torch.zeros(3, 3)).result(timeout=30)
        ids, _, _ = sched.query(q, topk=TOPK).result(timeout=30)
        assert ids.shape == (TOPK,)


@pytest.mark.parametrize("shards", LAYOUTS)
def test_ingest_lane_orders_mutations_and_swaps(shards):
    svc = _service(shards)
    direct = _service(shards)
    _mutate(direct)
    direct.apply_swap(direct.prepare_compact())
    corpus, _ = _data()
    with tsched.ServingScheduler(svc, max_batch=4, deadline_ms=5.0) as sched:
        sched.insert(torch.from_numpy(corpus[:N_INS] + 0.5))
        sched.delete([3, 10, 25, N_CORPUS + 2])
        assert sched.compact().result(timeout=60) is svc
        got = _schedule(sched)
    _assert_same(got, _answers(direct))
    assert not svc.index.store.mutated
    assert svc.stats.compactions == 1 and svc.stats.inserted == N_INS


def test_flush_and_close_contract():
    svc = _service(None)
    sched = tsched.ServingScheduler(svc, max_batch=4, deadline_ms=5.0)
    futs = [sched.query(q, topk=TOPK) for q in _queries()]
    sched.flush(timeout=30)
    assert all(f.done() for f in futs)
    sched.close()
    sched.close()                      # idempotent
    assert not sched._query_thread.is_alive()
    assert not sched._ingest_thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        sched.query(_queries()[0])
    assert sched.streams == {}         # a CPU tenant has no streams


def test_constructor_refuses_bad_knobs():
    svc = _service(None)
    for kw, msg in ((dict(max_batch=0), "max_batch"),
                    (dict(deadline_ms=-1.0), "deadline_ms"),
                    (dict(ingest_retries=-1), "ingest_retries")):
        with pytest.raises(ValueError, match=msg):
            tsched.ServingScheduler(svc, **kw)


# ---------------------------------------------------------------------------
# Namespaces (TestNamespaces)
# ---------------------------------------------------------------------------


def _two_tenant(module=tsched, service=_service):
    svc_a, svc_b = service(None), service(2)
    sched = module.ServingScheduler(
        {"a": svc_a, "b": svc_b}, max_batch=4, deadline_ms=5.0,
        quotas={"a": module.TenantQuota(max_items=N_CORPUS + 4)})
    return sched, svc_a, svc_b


def test_tenants_route_to_their_own_index():
    sched, svc_a, svc_b = _two_tenant()
    q = _queries()
    with sched:
        assert sorted(sched.namespaces()) == ["a", "b"]
        assert sched.service("a") is svc_a
        ra = sched.query(q[0], tenant="a", topk=TOPK).result(30)
        rb = sched.query(q[0], tenant="b", topk=TOPK).result(30)
        da = svc_a.query_arrays(q[:1], topk=TOPK)
        db = svc_b.query_arrays(q[:1], topk=TOPK)
        np.testing.assert_array_equal(ra[0], da[0][0])
        np.testing.assert_array_equal(rb[0], db[0][0])
        # per-tenant counters stay per-tenant (1 scheduled + 1 direct)
        assert sched.tenant_stats("a").queries == 2
        assert sched.tenant_stats("b").queries == 2
        with pytest.raises(KeyError, match="unknown namespace"):
            sched.query(q[0], tenant="nope")
        with pytest.raises(ValueError, match="already registered"):
            sched.add_namespace("a", svc_a)


@pytest.mark.parametrize("side", ["port", "reference"])
def test_max_items_quota_rejects_oversize_insert(side):
    corpus, _ = _data()
    if side == "port":
        sched, svc_a, _ = _two_tenant()
        wrap = torch.from_numpy
    else:
        sched, svc_a, _ = _two_tenant(jsched, _ref_service)
        wrap = np.asarray
    quota = tsched.QuotaExceeded if side == "port" else jsched.QuotaExceeded
    with sched:
        sched.insert(wrap(corpus[:4]), tenant="a").result(30)
        with pytest.raises(quota, match="max_items") as exc:
            sched.insert(wrap(corpus[:1]), tenant="a")
        assert svc_a.stats.rejected == 1
        # tenant "b" has no quota: the same insert admits fine
        sched.insert(wrap(corpus[:1]), tenant="b").result(30)
    assert str(exc.value) == (
        f"insert of 1 items would grow tenant 'a' past max_items="
        f"{N_CORPUS + 4} (live={N_CORPUS + 4})")


def test_max_pending_quota_sheds_load():
    svc = _service(None)
    sched = tsched.ServingScheduler(
        svc, max_batch=4, deadline_ms=5.0,
        quotas={"default": tsched.TenantQuota(max_pending=0)})
    with sched:
        with pytest.raises(tsched.QuotaExceeded, match="max_pending"):
            sched.query(_queries()[0])
        assert svc.stats.rejected == 1
    svc.stats.reset_mutations()
    assert svc.stats.rejected == 0


# ---------------------------------------------------------------------------
# Swaps racing queries (TestSwapInterleaving)
# ---------------------------------------------------------------------------


def _race(svc, prepare):
    """Serve direct batches on a thread while ``prepare`` builds and the
    main thread publishes -> (pre, results during the build, all results,
    post)."""
    pre = _answers(svc)
    results, done = [], threading.Event()

    def serve():
        while not done.is_set():
            results.append(_answers(svc))

    thread = threading.Thread(target=serve)
    thread.start()
    try:
        pending = prepare()
        assert pending is not None      # the mutations gave it work
        mid = list(results)
        svc.apply_swap(pending)
    finally:
        done.set()
        thread.join(timeout=60)
    assert not thread.is_alive()
    return pre, mid, results, _answers(svc)


@pytest.mark.parametrize("kind,shards", [("compact", None),
                                         ("compact", 2),
                                         ("rebalance", 2)])
def test_queries_racing_a_swap_are_never_torn(kind, shards):
    svc = _service(shards)
    _mutate(svc)
    svc.index.swap_chunk_rows = 8       # many bounded steps to race
    prepare = getattr(svc, f"prepare_{kind}")
    pre, mid, results, post = _race(svc, prepare)
    for r in mid:       # every query that raced the build saw the live store
        _assert_same(r, pre)
    for r in results:   # ... and one racing the publish one of the two
        assert _matches(r, pre) or _matches(r, post), \
            "a query racing the swap returned a torn mixture"
    assert not svc.index.store.mutated


@pytest.mark.parametrize("shards", LAYOUTS)
def test_stale_swap_rejected_after_interleaved_mutation(shards):
    """A mutation between prepare and apply invalidates the shadow:
    publishing it would silently drop the mutation."""
    svc = _service(shards)
    _mutate(svc)
    pending = svc.prepare_compact()
    svc.insert(torch.from_numpy(_data()[0][:2] + 1.0))
    with pytest.raises(RuntimeError, match="mutated"):
        svc.apply_swap(pending)
    svc.apply_swap(svc.prepare_compact())
    assert not svc.index.store.mutated
    _answers(svc)


@pytest.mark.parametrize("shards", LAYOUTS)
def test_scheduled_queries_racing_compaction_are_pinned(shards):
    """Through the scheduler: queries submitted around a compaction on the
    ingest lane each equal the direct pre- or post-swap rows."""
    svc = _service(shards)
    _mutate(svc)
    svc.index.swap_chunk_rows = 8
    q = _queries()
    pre = _answers(svc)
    with tsched.ServingScheduler(svc, max_batch=3, deadline_ms=1.0) as sched:
        futs = [sched.query(q[i % N_QUERIES], topk=TOPK) for i in range(12)]
        swap = sched.compact()
        futs += [sched.query(q[i % N_QUERIES], topk=TOPK)
                 for i in range(12, 48)]
        swap.result(timeout=60)
        got = [f.result(timeout=60) for f in futs]
    post = _answers(svc)
    for i, g in enumerate(got):
        row = i % N_QUERIES
        assert any(_matches(g, (w[0][row], w[1][row], int(w[2][row])))
                   for w in (pre, post))
    assert svc.stats.compactions == 1 and sched.stats.requests == 48


# ---------------------------------------------------------------------------
# The chunked fold (TestChunkedFoldParity)
# ---------------------------------------------------------------------------


def _assert_base_equal(a, b):
    assert a.cap == b.cap and type(a) is type(b)
    for name in ("keys", "sorted_keys", "perm", "stacked"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for x, y in zip(a.corpus.leaves, b.corpus.leaves):
        assert torch.equal(x, y)
    if hasattr(a, "counts"):
        assert a.counts == b.counts


@pytest.mark.parametrize("shards", LAYOUTS)
def test_chunked_store_bit_identical_to_one_pass(shards):
    one, chunked = _service(shards), _service(shards)
    one.index.swap_chunk_rows = None
    chunked.index.swap_chunk_rows = 16   # many chunks over 67 items
    for svc in (one, chunked):
        _mutate(svc)
        svc.apply_swap(svc.prepare_compact())
    _assert_base_equal(one.index.store.base, chunked.index.store.base)
    va, vb = one.index.store.view, chunked.index.store.view
    for x, y in zip(va.tensors(), vb.tensors()):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(one.index.store.slot_pos[0],
                                  chunked.index.store.slot_pos[0])
    _assert_same(_answers(one), _answers(chunked))


@pytest.mark.parametrize("shards", LAYOUTS)
def test_chunked_fold_matches_reference_chunked_fold(shards):
    """The reference's mutated store, carried across: the port's chunked
    compaction gives the reference's chunked compaction bit for bit
    (keys, sorted keys, perm, cap, counts, corpus)."""
    ref = _ref_service(shards)
    _mutate(ref, np.asarray)
    svc = _service(shards)
    svc.index.store = tb.carry_store(ref.index.store)
    ref.index.swap_chunk_rows = svc.index.swap_chunk_rows = 16
    for s in (ref, svc):
        s.apply_swap(s.prepare_compact())
    t, j = svc.index.store.base, ref.index.store.base
    np.testing.assert_array_equal(t.keys.numpy(),
                                  np.asarray(j.keys).astype(np.int64))
    np.testing.assert_array_equal(t.sorted_keys.numpy(),
                                  np.asarray(j.sorted_keys).astype(np.int64))
    np.testing.assert_array_equal(t.perm.numpy(), np.asarray(j.perm))
    assert t.cap == j.cap and getattr(t, "counts", 0) == getattr(j, "counts",
                                                                  0)
    want = tb.leaves_of(j.corpus)          # one array for a dense corpus
    for a, b in zip(t.corpus.leaves, [want] if isinstance(
            want, np.ndarray) else want):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(svc.index.store.slot_pos[0],
                                  ref.index.store.host_state()["slot_pos"][0])


def test_cooperative_build_yields_per_step_on_its_thread_only():
    """Inside ``cooperative_build`` every bounded step of a chunked fold
    asks ``busy`` (the keys gather, L table sorts, one step a chunk of each
    source segment); the
    setting is the thread's own, and a plain fold asks nothing."""
    svc = _service(None)
    _mutate(svc)
    svc.index.swap_chunk_rows = 16
    asked, other = [], []
    seen = threading.Event()

    def elsewhere():
        tseg._yield_slot()              # another thread: no throttle
        other.append(True)
        seen.set()

    with tseg.cooperative_build(yield_s=1e-4,
                                busy=lambda: asked.append(1) or True):
        thread = threading.Thread(target=elsewhere)
        thread.start()
        assert seen.wait(30)
        thread.join(timeout=30)
        pending = svc.prepare_compact()
    store, off, chunks = svc.index.store, 0, 0
    for seg in [store.base] + store.deltas:     # chunks a source segment
        chunks += -(-int(store.live_host[off:off + seg.slots].sum()) // 16)
        off += seg.slots
    assert chunks == 5
    assert len(asked) == 1 + 4 + chunks         # keys, 4 tables, chunks
    assert other == [True]
    asked.clear()
    svc.apply_swap(pending)
    _mutate(svc)
    svc.prepare_compact()
    assert asked == []


# ---------------------------------------------------------------------------
# Retries, degrade, shed and timeouts (tests/test_durability.py's
# TestDegradedServing, without a WAL)
# ---------------------------------------------------------------------------


def _flaky(base):
    """``base`` whose ``insert`` fires the injector's "pre_wal_append"
    point first, as the durable service does before its commit."""
    class Flaky(base):
        injector = None

        def insert(self, batch, *args, **kw):
            self.injector.fire("pre_wal_append")
            return super().insert(batch, *args, **kw)
    return Flaky


SIDES = {
    "port": dict(sched=tsched, dur=tdur, wrap=torch.from_numpy,
                 service=lambda **kw: _service(None, cls=_flaky(LSHService),
                                               **kw)),
    "reference": dict(sched=jsched, dur=jdur, wrap=np.asarray,
                      service=lambda **kw: _ref_service(
                          None, cls=_flaky(JaxService), **kw)),
}


def _batch(k=5, seed=0):
    return np.random.RandomState(seed).randn(k, *grids.DIMS).astype(
        np.float32)


def _outcome(fut):
    try:
        fut.result(timeout=60)
        return "ok"
    except Exception as exc:        # the type's name is the comparable part
        return type(exc).__name__


def _shed(fn):
    try:
        fn()
        return "admitted"
    except Exception as exc:
        return type(exc).__name__


def _scenario(name, side):
    s = SIDES[side]
    dur, mod, wrap = s["dur"], s["sched"], s["wrap"]
    inj = dur.FaultInjector()
    svc = s["service"]()
    svc.injector = inj
    q = wrap(_data()[1][0])
    out = {}
    if name == "transient_retry":
        inj.fail_transient("pre_wal_append", times=2)
        with mod.ServingScheduler(svc, retry_backoff_ms=1.0) as sched:
            out["insert"] = _outcome(sched.insert(wrap(_batch())))
    elif name == "exhausted_retries":
        with mod.ServingScheduler(svc, ingest_retries=2,
                                  retry_backoff_ms=1.0) as sched:
            out["first"] = _outcome(sched.insert(wrap(_batch(seed=1))))
            inj.fail_transient("pre_wal_append", times=3)
            out["second"] = _outcome(sched.insert(wrap(_batch(seed=2))))
            out["health_after"] = svc.health
            out["query"] = _shed(lambda: sched.query(q))
            out["insert"] = _shed(lambda: sched.insert(wrap(_batch(seed=3))))
            out["recover"] = _shed(lambda: sched.recover_namespace())
    elif name == "injected_crash":
        inj.crash_at("pre_wal_append", after=1)
        with mod.ServingScheduler(svc) as sched:
            out["first"] = _outcome(sched.insert(wrap(_batch(seed=4))))
            out["second"] = _outcome(sched.insert(wrap(_batch(seed=5))))
            out["query"] = _shed(lambda: sched.query(q))
    elif name == "poisoned_insert":
        with mod.ServingScheduler(svc) as sched:
            out["poison"] = _outcome(sched.insert(
                wrap(np.zeros((2, 3), np.float32)))) != "ok"
            out["after"] = _outcome(sched.insert(wrap(_batch())))
            out["last_error_set"] = sched.tenant_stats().last_error != ""
    elif name == "request_timeout":
        with mod.ServingScheduler(svc, request_timeout_ms=0.0,
                                  deadline_ms=1.0) as sched:
            fut = sched.query(q)
            out["query"] = _outcome(fut)
            out["is_timeout"] = isinstance(fut.exception(timeout=60),
                                           TimeoutError)
    elif name == "flush_timeout":
        with mod.ServingScheduler(svc) as sched:
            orig = svc.insert
            svc.insert = lambda b: (time.sleep(0.3), orig(b))[1]
            fut = sched.insert(wrap(_batch()))
            try:
                sched.flush(timeout=0.02)
                out["flush"] = "drained"
            except TimeoutError as exc:
                out["flush"] = str(exc)
            out["insert"] = _outcome(fut)
            sched.flush(timeout=60)
            out["flushed"] = True
    st = sched.stats
    tenant = svc.stats
    out.update(health=svc.health, errors=(st.errors, tenant.errors),
               retries=(st.retries, tenant.retries),
               timeouts=(st.timeouts, tenant.timeouts), shed=st.shed,
               unavailable=tenant.unavailable,
               last_error=(st.last_error if name != "poisoned_insert"
                           else None),
               inserted=svc.index.size, fired=len(inj.fired))
    return out


@pytest.mark.parametrize("name", ["transient_retry", "exhausted_retries",
                                  "injected_crash", "poisoned_insert",
                                  "request_timeout", "flush_timeout"])
def test_degraded_serving_matches_reference(name):
    got, want = _scenario(name, "port"), _scenario(name, "reference")
    assert got == want
    expect = {"transient_retry": dict(retries=(2, 2), health="serving"),
              "exhausted_retries": dict(errors=(1, 1), health="degraded",
                                        shed=2, recover="TypeError"),
              "injected_crash": dict(errors=(1, 1), health="degraded",
                                     second="InjectedCrash"),
              "poisoned_insert": dict(errors=(1, 1), health="serving",
                                      after="ok"),
              "request_timeout": dict(query="RequestTimeout",
                                      timeouts=(1, 1)),
              "flush_timeout": dict(insert="ok", flushed=True)}[name]
    for key, value in expect.items():
        assert got[key] == value, (key, got)


def test_injector_rejects_unknown_points():
    with pytest.raises(ValueError, match="unknown crash point"):
        tdur.FaultInjector().crash_at("pre_frobnicate")
    assert tdur.CRASH_POINTS == jdur.CRASH_POINTS
    assert issubclass(tdur.TransientIOError, OSError)
    assert issubclass(tdur.WalCorrupted, tdur.DurabilityError)


# ---------------------------------------------------------------------------
# Durable tenants (tests/test_durability.py's TestDegradedServing, with the
# WAL): recover_namespace replays the committed prefix
# ---------------------------------------------------------------------------


def _durable(directory, injector):
    return _service(None, cls=tdur.DurableLSHService,
                    directory=str(directory), injector=injector,
                    snapshot_every=10 ** 9)


def _assert_committed_prefix(svc, ops):
    """``svc`` answers (rows and candidate sets) as a plain service that
    applied ``ops`` (callables on the service) and nothing else."""
    ref = _service(None)
    for op in ops:
        op(ref)
    _assert_same(_answers(svc), _answers(ref))
    for q in _queries()[:3]:
        np.testing.assert_array_equal(svc.index.candidates(q),
                                      ref.index.candidates(q))
    return ref


def test_durable_transient_wal_failure_retries_and_commits_once(tmp_path):
    inj = tdur.FaultInjector().fail_transient("pre_wal_append", times=2)
    svc = _durable(tmp_path, inj)
    with tsched.ServingScheduler(svc, retry_backoff_ms=1.0) as sched:
        sched.insert(torch.from_numpy(_batch())).result(timeout=60)
        assert sched.stats.retries == 2 and svc.stats.retries == 2
        assert sched.stats.errors == 0 and svc.health == "serving"
    records, _ = tdur.read_wal(str(tmp_path))
    assert [k for _, k, _ in records] == ["insert"]
    assert svc.stats.wal_appends == 1


def test_durable_exhausted_retries_degrade_then_recover(tmp_path):
    inj = tdur.FaultInjector()
    svc = _durable(tmp_path, inj)
    q = _queries()[0]
    first = torch.from_numpy(_batch(seed=1))
    with tsched.ServingScheduler(svc, ingest_retries=2,
                                 retry_backoff_ms=1.0) as sched:
        sched.insert(first).result(timeout=60)
        inj.fail_transient("pre_wal_append", times=3)  # 1 try + 2 retries
        with pytest.raises(tdur.TransientIOError):
            sched.insert(torch.from_numpy(_batch(seed=2))).result(timeout=60)
        assert svc.health == "degraded"
        assert sched.stats.errors == 1
        assert "TransientIOError" in sched.tenant_stats().last_error
        with pytest.raises(tdur.ServiceUnavailable):
            sched.query(q)
        with pytest.raises(tdur.ServiceUnavailable):
            sched.insert(torch.from_numpy(_batch(seed=3)))
        assert sched.stats.shed == 2 and svc.stats.unavailable >= 2
        assert sched.recover_namespace().result(timeout=120) is svc
        assert svc.health == "serving" and svc.stats.recoveries == 1
        got = sched.query(q, topk=TOPK).result(timeout=60)
    # the shed and the failed inserts never committed: insert #1 only
    ref = _assert_committed_prefix(svc, [lambda s: s.insert(first)])
    want = ref.query_arrays(_queries()[:1], topk=TOPK)
    _assert_same(got, (want[0][0], want[1][0], int(want[2][0])))


def test_durable_injected_crash_recovers_the_committed_delete(tmp_path):
    """A crash right after the delete's record synced: the tenant degrades
    and sheds; recovery replays the delete (it committed), and the next
    scheduled query equals the direct row of that store."""
    inj = tdur.FaultInjector().crash_at("post_wal_append", after=1)
    svc = _durable(tmp_path, inj)
    q = _queries()[0]
    first = torch.from_numpy(_batch(seed=4))
    with tsched.ServingScheduler(svc) as sched:
        sched.insert(first).result(timeout=60)
        with pytest.raises(tdur.InjectedCrash):
            sched.delete([1, 8]).result(timeout=60)
        assert svc.health == "degraded" and sched.stats.errors == 1
        with pytest.raises(tdur.ServiceUnavailable):
            sched.query(q)
        sched.recover_namespace().result(timeout=120)
        got = sched.query(q, topk=TOPK).result(timeout=60)
    assert svc.last_recovery["records"] == 2
    ref = _assert_committed_prefix(
        svc, [lambda s: s.insert(first), lambda s: s.delete([1, 8])])
    want = ref.query_arrays(_queries()[:1], topk=TOPK)
    _assert_same(got, (want[0][0], want[1][0], int(want[2][0])))
