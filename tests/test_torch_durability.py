"""Port parity: durability (``repro_torch.serving.durability``), the WAL,
atomic snapshots, ``DurableLSHService`` and ``recover()``, against the
port's own plain ``LSHService`` and against the reference
(``repro.serving.durability``), services on the CPU.

* Port against port (the reference's ``tests/test_durability.py``): for
  every crash point, seeded kill schedules and a kind x shard-count chaos
  cell, at the layouts (None, 1, 2, 4), a recovered service answers
  (ids, scores, counts, candidate sets) bit for bit as a fresh plain
  service that applied exactly the committed prefix; periodic snapshots
  rotate and prune; the WAL edge cases (torn tail, mid-log checksum, lsn
  gap, empty log, snapshot without a log, epoch markers, no snapshot,
  config mismatch, interrupted snapshot); CP and TT corpora with deletes
  and compactions; health gating.
* Against the reference: for ``_fixed_ops()`` the WAL segment files equal
  the reference's byte for byte, and the build's snapshot arrays and
  config the reference's; the port recovers directories the reference
  wrote (dense at S = None and S = 2 with a torn final record, a CP and a
  TT corpus with deletes and a compact) and answers as the reference's
  live service within the parity contract (counts equal outside
  ``near`` rows, ids equal except at near ties, scores within
  ``parity.rerank_bound``); another ``num_tables`` is refused by name; a
  CP insert is refused by name before anything is written (ROADMAP.md
  R6); a snapshot skeleton naming another class is refused.
* The reference reads the port's directories (ROADMAP.md F4): its
  ``recover()`` of a dense directory the port wrote (S = None and 2; an
  insert, deletes, a compact and an insert) and of CP and TT ones (deletes
  and a compact) answers as the port's live service within the parity
  contract; the port's CP / TT skeleton is the reference's pickle of that
  skeleton byte for byte, with its tree structure; and the port recovers
  from its own skeleton when ``corpus_format`` is gone.

The reference hashes through XLA here: no Pallas compilation (R3).
"""

import base64
import functools
import json
import os
import pickle
import struct

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import grids
import torch_bridge as tb
from repro.serving import durability as jdur
from repro.serving.lsh_service import LSHService as JaxService
from repro_torch.core.projections import project_batch
from repro_torch.core.tensor_formats import as_batch
from repro_torch.kernels import parity
from repro_torch.serving.durability import (_ALIGN, CRASH_POINTS,
                                            DurableLSHService, FaultInjector,
                                            InjectedCrash, RecoveryError,
                                            ServiceUnavailable, WalCorrupted,
                                            _service_config, latest_snapshot,
                                            read_wal)
from repro_torch.serving.lsh_service import LSHService

TOPK = 6
N_CORPUS = 67          # coprime to every shard count: padded last shard
N_QUERIES = 5
KIND = "cp-e2lsh"
LAYOUTS = (None,) + grids.SHARD_COUNTS    # device + sharded S in {1,2,4}
NO_SNAP = 10 ** 9      # snapshot_every that never triggers mid-test

# Which side of the crash point the in-flight operation lands on:
# pre_wal_append fires before the record exists (not committed); the other
# points fire after the fsync (committed, though the caller saw the crash).
COMMITS_INFLIGHT = {"pre_wal_append": False, "post_wal_append": True,
                    "mid_snapshot": True, "pre_apply_swap": True}


@functools.lru_cache(maxsize=None)
def _jax_family(kind=KIND, num_tables=4):
    return grids.grid_family(kind, num_tables=num_tables, hash_backend="xla")


@functools.lru_cache(maxsize=None)
def _family(kind=KIND, num_tables=4):
    return tb.bridge_family(_jax_family(kind, num_tables))


@functools.lru_cache(maxsize=None)
def _data():
    corpus, queries = grids.corpus_and_queries(N_CORPUS, N_QUERIES)
    return np.array(corpus), np.array(queries)


def _queries():
    return torch.from_numpy(_data()[1])


def _durable(directory, shards=None, kind=KIND, injector=None,
             snapshot_every=NO_SNAP, build=True, **kw):
    kw.setdefault("bucket_cap", 16)
    kw.setdefault("max_deltas", 64)
    svc = DurableLSHService(_family(kind), str(directory),
                            metric=grids.metric_for(kind), shards=shards,
                            injector=injector,
                            snapshot_every=snapshot_every, **kw)
    if build:
        svc.build(torch.from_numpy(_data()[0]))
    return svc


def _recovered(directory, shards=None, kind=KIND, **kw):
    return _durable(directory, shards=shards, kind=kind, build=False,
                    **kw).recover()


def _plain(shards=None, kind=KIND, **kw):
    kw.setdefault("bucket_cap", 16)
    kw.setdefault("max_deltas", 64)
    return LSHService(_family(kind), metric=grids.metric_for(kind),
                      shards=shards, **kw).build(
                          torch.from_numpy(_data()[0]))


def _schedule(seed, n_ops, live=N_CORPUS):
    """A deterministic interleaved op list. Delete ids are drawn against
    the simulated live count, so applying any prefix to any equally-built
    service is well-defined."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n_ops):
        r = rng.rand()
        if r < 0.55 or live < 16:
            k = int(rng.randint(1, 7))
            ops.append(("insert", rng.randn(k, *grids.DIMS)
                        .astype(np.float32)))
            live += k
        elif r < 0.85:
            ids = np.unique(rng.randint(0, live, size=int(rng.randint(1, 4))))
            ops.append(("delete", ids.astype(np.int64)))
            live -= len(ids)
        else:
            ops.append(("compact", None))
    return ops


def _fixed_ops():
    """insert/delete/compact mix with the epoch markers at known slots
    (records 3 and 6), so every crash point can be aimed precisely."""
    rng = np.random.RandomState(3)
    mk = lambda k: rng.randn(k, *grids.DIMS).astype(np.float32)  # noqa: E731
    return [("insert", mk(5)), ("delete", np.array([3, 11])),
            ("insert", mk(4)), ("compact", None), ("insert", mk(3)),
            ("delete", np.array([0, 20, 40])), ("compact", None),
            ("insert", mk(6))]


def _apply(svc, op, wrap=torch.from_numpy):
    kind, arg = op
    if kind == "insert":
        svc.insert(wrap(arg))
    elif kind == "delete":
        svc.delete(arg)
    else:
        svc.compact()


def _run_until_crash(svc, ops, queries=None):
    """Apply ops until an injected crash; -> (applied_ops, inflight_op).
    ``queries`` interleaves query traffic between mutations."""
    applied = []
    for i, op in enumerate(ops):
        try:
            _apply(svc, op)
        except InjectedCrash:
            return applied, op
        applied.append(op)
        if queries is not None and i % 3 == 2:
            svc.query_arrays(queries[:2], topk=4)
    return applied, None


def _committed(applied, inflight, point):
    if inflight is not None and COMMITS_INFLIGHT[point]:
        return applied + [inflight]
    return applied


def _assert_bit_identical(got, want, queries=None):
    """ids, scores, counts AND candidate sets, all exactly equal."""
    queries = _queries() if queries is None else queries
    a, b = got.query_arrays(queries, topk=TOPK), \
        want.query_arrays(queries, topk=TOPK)
    for name, x, y in zip(("ids", "scores", "n_cand"), a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)
    for i in range(3):
        q = (queries[i] if isinstance(queries, torch.Tensor)
             else queries.index(i))
        np.testing.assert_array_equal(got.index.candidates(q),
                                      want.index.candidates(q),
                                      err_msg="candidate set")


def _wal_paths(directory):
    return sorted(os.path.join(str(directory), n)
                  for n in os.listdir(str(directory))
                  if n.startswith("wal_") and n.endswith(".log"))


def _frames(path):
    """(offset, length) of each record in a segment (aligned stepping,
    zero-length sentinel = end)."""
    with open(path, "rb") as f:
        data = f.read()
    out, off = [], 0
    while off + 8 <= len(data):
        length, _ = struct.unpack_from("<II", data, off)
        if length == 0:
            break
        out.append((off, length))
        off = (off + 8 + length + _ALIGN - 1) // _ALIGN * _ALIGN
    return out


# ---------------------------------------------------------------------------
# Recovery parity, port against port
# ---------------------------------------------------------------------------


class TestRecoveryParity:
    @pytest.mark.parametrize("shards", LAYOUTS)
    def test_clean_recovery_matches_live_service(self, tmp_path, shards):
        svc = _durable(tmp_path, shards=shards)
        for op in _fixed_ops():
            _apply(svc, op)
        rec = _recovered(tmp_path, shards=shards)
        _assert_bit_identical(rec, svc)
        assert rec.stats.recoveries == 1
        assert rec.stats.compactions == 2     # replayed both epoch markers
        assert rec.health == "serving"
        assert rec.last_recovery["records"] == len(_fixed_ops())
        # the recovered WAL accepts new commits and they recover again
        # (close the original's log first: one writer per directory)
        svc.close()
        extra = np.float32(np.random.RandomState(5).randn(3, *grids.DIMS))
        rec.insert(torch.from_numpy(extra))
        ref = _plain(shards=shards)
        for op in _fixed_ops() + [("insert", extra)]:
            _apply(ref, op)
        _assert_bit_identical(_recovered(tmp_path, shards=shards), ref)

    @pytest.mark.parametrize("shards", LAYOUTS)
    @pytest.mark.parametrize("point", CRASH_POINTS)
    def test_crash_point_matrix(self, tmp_path, shards, point):
        """Every durability boundary: kill there, recover, compare to a
        fresh service that applied exactly the committed prefix."""
        inj = FaultInjector()
        snap_every = 4 if point == "mid_snapshot" else NO_SNAP
        inj.crash_at(point, after={"pre_apply_swap": 0, "mid_snapshot": 1}
                     .get(point, 3))
        svc = _durable(tmp_path, shards=shards, injector=inj,
                       snapshot_every=snap_every)
        applied, inflight = _run_until_crash(svc, _fixed_ops(), _queries())
        assert inflight is not None, "the armed crash point never fired"
        rec = _recovered(tmp_path, shards=shards)
        ref = _plain(shards=shards)
        for op in _committed(applied, inflight, point):
            _apply(ref, op)
        _assert_bit_identical(rec, ref)

    @pytest.mark.parametrize("shards", LAYOUTS)
    @pytest.mark.parametrize("seed", (1, 2))
    def test_random_kill_schedule(self, tmp_path, shards, seed):
        """Seeded chaos: a random kill point over a random interleaved
        schedule, with periodic snapshots in the mix."""
        rng = np.random.RandomState(97 * seed + (0 if shards is None
                                                 else shards))
        point = CRASH_POINTS[rng.randint(len(CRASH_POINTS))]
        after = int(rng.randint(0, 8)) + (point == "mid_snapshot")
        inj = FaultInjector().crash_at(point, after=after)
        svc = _durable(tmp_path, shards=shards, injector=inj,
                       snapshot_every=6)
        ops = _schedule(seed=int(rng.randint(10 ** 6)), n_ops=14)
        applied, inflight = _run_until_crash(svc, ops, _queries())
        rec = _recovered(tmp_path, shards=shards)
        ref = _plain(shards=shards)
        for op in _committed(applied, inflight, point):
            _apply(ref, op)
        _assert_bit_identical(rec, ref)

    # one chaos cell per kind x shard-count, with the reference's marks:
    # the canonical kind's full S sweep and every kind at S = 2 unmarked
    @pytest.mark.parametrize(
        "kind,shards",
        [pytest.param(kind, s,
                      marks=() if (kind == KIND or s == 2)
                      else (pytest.mark.slow,))
         for kind in grids.ALL_KINDS for s in grids.SHARD_COUNTS])
    def test_chaos_cell_across_kinds(self, tmp_path, kind, shards):
        rng = np.random.RandomState((len(kind) * 131 + shards) % (2 ** 31))
        point = CRASH_POINTS[rng.randint(len(CRASH_POINTS))]
        after = int(rng.randint(0, 6)) + (point == "mid_snapshot")
        inj = FaultInjector().crash_at(point, after=after)
        svc = _durable(tmp_path, shards=shards, kind=kind, injector=inj,
                       snapshot_every=5)
        applied, inflight = _run_until_crash(
            svc, _schedule(seed=11, n_ops=10), _queries())
        rec = _recovered(tmp_path, shards=shards, kind=kind)
        ref = _plain(shards=shards, kind=kind)
        for op in _committed(applied, inflight, point):
            _apply(ref, op)
        _assert_bit_identical(rec, ref)

    def test_periodic_snapshots_rotate_and_prune(self, tmp_path):
        svc = _durable(tmp_path, snapshot_every=3, keep_snapshots=2)
        for op in _schedule(seed=23, n_ops=11):
            _apply(svc, op)
        snaps = [n for n in os.listdir(tmp_path) if n.startswith("snap_")
                 and not n.endswith(".tmp")]
        assert svc.stats.snapshots >= 3       # the build's + periodic ones
        assert len(snaps) <= 2                # pruned to keep_snapshots
        assert len(_wal_paths(tmp_path)) <= 2  # rotated + pruned with them
        _assert_bit_identical(_recovered(tmp_path), svc)

    @pytest.mark.parametrize("layout", ["cp", "tt"])
    @pytest.mark.parametrize("shards", [None, 2])
    def test_cp_and_tt_corpora_recover(self, tmp_path, layout, shards):
        """A CP or TT corpus: snapshots in its format (the port's
        ``corpus_format``), logged deletes and epoch markers, replayed bit
        for bit."""
        kind = f"{layout}-e2lsh"
        fx, wrap = ((tb.cp_fixture, tb.torch_cp) if layout == "cp"
                    else (tb.tt_fixture, tb.torch_tt))
        corpus, queries = fx(61, 5)
        fam = tb.bridge_family(_jax_family(kind))
        kw = dict(metric="euclidean", bucket_cap=16, max_deltas=64,
                  shards=shards)
        svc = DurableLSHService(fam, str(tmp_path), snapshot_every=4,
                                **kw).build(wrap(corpus, 0.5))
        svc.delete(np.array([2, 9, 30]))
        svc.compact()
        svc.delete(np.array([1, 40]))
        svc.snapshot()
        svc.delete(np.array([7]))
        if shards is not None:
            svc.rebalance()
        lsn = latest_snapshot(str(tmp_path))
        assert lsn == 3
        manifest = json.load(open(os.path.join(
            str(tmp_path), f"snap_{lsn:012d}", "manifest.json")))
        assert manifest["segments"][0]["corpus_format"] == {
            "format": layout, "scale": 0.5}
        rec = DurableLSHService(fam, str(tmp_path), **kw).recover()
        assert rec.last_recovery["records"] == (2 if shards else 1)
        _assert_bit_identical(rec, svc, wrap(queries, 0.5))


# ---------------------------------------------------------------------------
# WAL edge cases
# ---------------------------------------------------------------------------


class TestWalEdgeCases:
    def _three_inserts(self, tmp_path):
        svc = _durable(tmp_path)
        rng = np.random.RandomState(13)
        batches = [rng.randn(k, *grids.DIMS).astype(np.float32)
                   for k in (5, 4, 3)]
        for b in batches:
            svc.insert(torch.from_numpy(b))
        return svc, batches

    def test_torn_final_record_is_dropped(self, tmp_path):
        svc, batches = self._three_inserts(tmp_path)
        svc.close()
        path = _wal_paths(tmp_path)[-1]
        last_off, _ = _frames(path)[-1]
        with open(path, "r+b") as f:          # cut the tail mid-record
            f.truncate(last_off + 100)
        rec = _recovered(tmp_path)
        ref = _plain()
        ref.insert(torch.from_numpy(batches[0]))
        ref.insert(torch.from_numpy(batches[1]))  # the torn third is gone
        _assert_bit_identical(rec, ref)
        # and the truncated tail was healed: new commits recover fine
        rec.insert(torch.from_numpy(batches[2]))
        _assert_bit_identical(_recovered(tmp_path), rec)

    def test_checksum_corruption_mid_log_fails_loudly(self, tmp_path):
        self._three_inserts(tmp_path)
        path = _wal_paths(tmp_path)[-1]
        with open(path, "r+b") as f:          # flip a byte inside record 0
            f.seek(12)
            byte = f.read(1)
            f.seek(12)
            f.write(bytes([byte[0] ^ 0xFF]))
        with pytest.raises(WalCorrupted, match="checksum"):
            read_wal(str(tmp_path))
        fresh = _durable(tmp_path, build=False)
        with pytest.raises(WalCorrupted, match="checksum"):
            fresh.recover()
        assert fresh.health == "degraded"     # it never half-serves
        with pytest.raises(ServiceUnavailable):
            fresh.query_arrays(_queries(), topk=4)

    def test_lsn_gap_fails_loudly(self, tmp_path):
        svc, _ = self._three_inserts(tmp_path)
        svc.close()
        path = _wal_paths(tmp_path)[-1]
        with open(path, "rb") as f:
            data = f.read()
        offs = _frames(path)                  # reframe, dropping record 1
        rec = [data[o:o + 8 + n] for o, n in offs]
        pad = b"\0" * (offs[1][0] - len(rec[0]))
        with open(path, "wb") as f:
            f.write(rec[0] + pad + rec[2])
        with pytest.raises(WalCorrupted, match="discontinuity"):
            _durable(tmp_path, build=False).recover()

    def test_empty_log_recovers_to_snapshot(self, tmp_path):
        svc = _durable(tmp_path)              # build writes snapshot + empty
        rec = _recovered(tmp_path)            # WAL: zero records replayed
        _assert_bit_identical(rec, svc)
        assert rec.stats.wal_appends == 0

    def test_snapshot_with_no_log_recovers(self, tmp_path):
        svc, _ = self._three_inserts(tmp_path)
        svc.snapshot()                        # covers every record so far
        for p in _wal_paths(tmp_path):
            os.remove(p)                      # lose the (rotated) log
        rec = _recovered(tmp_path)
        _assert_bit_identical(rec, svc)

    def test_replay_across_epoch_marker(self, tmp_path):
        svc = _durable(tmp_path, shards=2)
        rng = np.random.RandomState(31)
        svc.insert(torch.from_numpy(rng.randn(6, *grids.DIMS)
                                    .astype(np.float32)))
        svc.delete(np.array([2, 40]))
        svc.compact()                         # epoch marker mid-log
        svc.insert(torch.from_numpy(rng.randn(4, *grids.DIMS)
                                    .astype(np.float32)))
        svc.rebalance()                       # second marker kind
        records, _ = read_wal(str(tmp_path))
        assert [k for _, k, _ in records] == [
            "insert", "delete", "compact", "insert", "rebalance"]
        rec = _recovered(tmp_path, shards=2)
        assert rec.stats.compactions == 1 and rec.stats.rebalances == 1
        assert not rec.index.store.mutated
        _assert_bit_identical(rec, svc)

    def test_no_snapshot_fails_loudly(self, tmp_path):
        with pytest.raises(RecoveryError, match="no complete snapshot"):
            _durable(tmp_path, build=False).recover()

    def test_config_mismatch_refuses_replay(self, tmp_path):
        self._three_inserts(tmp_path)
        other = DurableLSHService(_family(KIND, num_tables=2), str(tmp_path),
                                  metric="euclidean", bucket_cap=16)
        with pytest.raises(RecoveryError, match="num_tables"):
            other.recover()

    def test_interrupted_snapshot_leaves_last_complete_one(self, tmp_path):
        """A crash mid-snapshot leaves only an ignored .tmp dir; recovery
        restores the previous snapshot and replays the full log."""
        inj = FaultInjector().crash_at("mid_snapshot", after=1)
        svc = _durable(tmp_path, injector=inj)
        svc.insert(torch.from_numpy(np.random.RandomState(7).randn(
            5, *grids.DIMS).astype(np.float32)))
        with pytest.raises(InjectedCrash):
            svc.snapshot()
        assert any(n.endswith(".tmp") for n in os.listdir(tmp_path))
        _assert_bit_identical(_recovered(tmp_path), svc)


# ---------------------------------------------------------------------------
# Direct durable-service gating
# ---------------------------------------------------------------------------


class TestHealthGating:
    def test_cold_and_degraded_services_refuse_requests(self, tmp_path):
        svc = _durable(tmp_path, build=False)
        assert svc.health == "cold"
        with pytest.raises(ServiceUnavailable):
            svc.insert(torch.zeros((1,) + grids.DIMS))
        with pytest.raises(ServiceUnavailable):
            svc.query_arrays(torch.zeros((1,) + grids.DIMS))
        assert svc.stats.unavailable == 2

    def test_counters_reset_with_the_mutations(self, tmp_path):
        svc, _ = TestWalEdgeCases()._three_inserts(tmp_path)
        st = svc.stats
        assert st.wal_appends == 3 and st.wal_ms > 0
        assert st.snapshots == 1 and st.snapshot_ms > 0
        svc.snapshot()
        assert st.snapshots == 2
        st.reset_mutations()
        assert (st.wal_appends, st.snapshots, st.recoveries) == (0, 0, 0)
        assert st.wal_ms == st.snapshot_ms == st.recovery_ms == 0.0


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def _jax_durable(directory, shards=None, family=None, **kw):
    kw.setdefault("bucket_cap", 16)
    kw.setdefault("max_deltas", 64)
    return jdur.DurableLSHService(family or _jax_family(), str(directory),
                                  metric="euclidean", shards=shards,
                                  snapshot_every=NO_SNAP, **kw)


@pytest.mark.parametrize("shards", [None, 2])
def test_wal_files_equal_the_reference(tmp_path, shards):
    """The same operations write the reference's WAL segment files byte
    for byte, and the build's snapshot holds the reference's arrays (keys
    and sorted keys uint32, perms int32) and config."""
    jdir, tdir = tmp_path / "ref", tmp_path / "port"
    ref = _jax_durable(jdir, shards).build(_data()[0])
    svc = _durable(tdir, shards=shards)
    for op in _fixed_ops():
        _apply(ref, op, np.asarray)
        _apply(svc, op)
    ref.close()
    svc.close()
    jw, tw = _wal_paths(jdir), _wal_paths(tdir)
    assert [os.path.basename(p) for p in jw] == [
        os.path.basename(p) for p in tw]
    for a, b in zip(jw, tw):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    assert _service_config(svc) == jdur._service_config(ref)
    snap = "snap_000000000000"
    jm = json.load(open(jdir / snap / "manifest.json"))
    tm = json.load(open(tdir / snap / "manifest.json"))
    assert jm["config"] == tm["config"]
    assert (jm["seq_len"], jm["live_window"]) == (tm["seq_len"],
                                                  tm["live_window"])
    for je, te in zip(jm["segments"], tm["segments"]):
        assert (je["type"], je["cap"], je.get("counts")) == (
            te["type"], te["cap"], te.get("counts"))
        for name in ("keys", "sorted_keys", "perm", "slot_pos"):
            a = np.load(jdir / snap / je[name]["file"])
            b = np.load(tdir / snap / te[name]["file"])
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            assert je[name]["crc32"] == te[name]["crc32"]
        (jc,), (tc,) = je["corpus"], te["corpus"]
        np.testing.assert_array_equal(np.load(jdir / snap / jc["file"]),
                                      np.load(tdir / snap / tc["file"]))


def _near_rows(tfam, queries) -> np.ndarray:
    """(B,) bool: queries with a code within the raw rounding bound of a
    bucket edge (E2LSH) or of 0 (SRP), where the two hashes may differ."""
    l, k = tfam.num_tables, tfam.num_codes
    if queries.layout != "dense":
        return tb.near_tables(tfam, [a.numpy() for a in queries.leaves]
                              ).any(axis=1)
    values = project_batch(tfam.projection, queries)
    bound = parity.family_raw_bound(tfam, queries)
    offs = None if tfam.offsets is None else tfam.offsets.reshape(l, k)
    b = values.shape[0]
    return parity.boundary_codes(values.reshape(b, l, k),
                                 bound.reshape(b, l, k), tfam.kind, offs,
                                 tfam.bucket_width).any(-1).any(-1).numpy()


def _assert_answers_as_reference(svc, ref, tq, jq):
    """The port's recovered answers against the reference's live ones:
    counts equal outside near rows, ids equal except at near ties, scores
    within the rounding bound."""
    ids, sc, nc = svc.query_arrays(tq, topk=TOPK)
    ri, rs, rn = (np.array(a) for a in ref.query_arrays(jq, topk=TOPK))
    clean = ~_near_rows(svc.index.family, tq)
    assert clean.any()
    np.testing.assert_array_equal(nc[clean], rn[clean])
    tol = parity.rerank_bound("euclidean", tq, svc.index.effective_corpus(),
                              torch.from_numpy(ri), torch.from_numpy(rs))
    rows = torch.from_numpy(clean)
    assert parity.topk_mismatches(
        torch.from_numpy(ids)[rows], torch.from_numpy(sc)[rows],
        torch.from_numpy(ri)[rows], torch.from_numpy(rs)[rows],
        tol[rows]) == 0
    keep = (ids == ri) & (ri >= 0)
    assert (np.abs(sc[keep] - rs[keep]) <= tol.numpy()[keep]).all()


@pytest.mark.parametrize("shards", [None, 2])
def test_recovers_a_dense_reference_directory_with_a_torn_tail(tmp_path,
                                                               shards):
    ref = _jax_durable(tmp_path, shards).build(_data()[0])
    ops = _fixed_ops()
    for op in ops:
        _apply(ref, op, np.asarray)
    ref.close()
    path = _wal_paths(tmp_path)[-1]
    last_off, _ = _frames(path)[-1]
    with open(path, "r+b") as f:              # tear the final insert
        f.truncate(last_off + 100)
    want = JaxService(_jax_family(), metric="euclidean", shards=shards,
                      bucket_cap=16, max_deltas=64).build(_data()[0])
    for op in ops[:-1]:
        _apply(want, op, np.asarray)
    rec = _recovered(tmp_path, shards=shards)
    assert rec.last_recovery["records"] == len(ops) - 1
    assert rec.stats.compactions == 2
    _assert_answers_as_reference(rec, want, as_batch(_queries()), _data()[1])
    # every stored key is the reference's (the snapshot's and the
    # replayed inserts' alike, on this fixture)
    for a, b in zip([rec.index.store.base] + rec.index.store.deltas,
                    [want.index.store.base] + want.index.store.deltas):
        np.testing.assert_array_equal(a.keys.numpy(),
                                      np.asarray(b.keys).astype(np.int64))


@pytest.mark.parametrize("layout", ["cp", "tt"])
def test_recovers_cp_and_tt_reference_directories(tmp_path, layout):
    """The reference pickles a ``CPTensor`` / ``TTTensor`` skeleton: the
    port reads it without the reference's package, replays the deletes and
    the compact on the stored keys, and answers as the reference."""
    kind = f"{layout}-e2lsh"
    fx, jwrap, twrap = ((tb.cp_fixture, tb.jax_cp, tb.torch_cp)
                        if layout == "cp" else
                        (tb.tt_fixture, tb.jax_tt, tb.torch_tt))
    corpus, queries = fx(61, 5)
    fam = _jax_family(kind)
    ref = _jax_durable(tmp_path, family=fam).build(jwrap(corpus, 0.5))
    ref.delete(np.array([2, 9, 30]))
    ref.compact()
    ref.delete(np.array([1, 40]))
    ref.close()
    rec = DurableLSHService(tb.bridge_family(fam), str(tmp_path),
                            metric="euclidean", bucket_cap=16,
                            max_deltas=64).recover()
    assert rec.last_recovery["records"] == 3
    assert rec.index.size == ref.index.size == 56
    np.testing.assert_array_equal(rec.index.store.base.keys.numpy(),
                                  np.asarray(ref.index.store.base.keys)
                                  .astype(np.int64))
    assert rec.index.effective_corpus().scale == 0.5
    _assert_answers_as_reference(rec, ref, twrap(queries, 0.5),
                                 jwrap(queries, 0.5))


def test_reference_manifest_of_another_num_tables_is_refused(tmp_path):
    ref = _jax_durable(tmp_path).build(_data()[0])
    ref.close()
    other = DurableLSHService(_family(KIND, num_tables=2), str(tmp_path),
                              metric="euclidean", bucket_cap=16,
                              max_deltas=64)
    with pytest.raises(RecoveryError, match="num_tables"):
        other.recover()
    assert other.health == "degraded"


def test_cp_insert_is_refused_before_anything_is_written(tmp_path):
    corpus, _ = tb.cp_fixture(61, 5)
    inj = FaultInjector()
    svc = DurableLSHService(tb.bridge_family(_jax_family()), str(tmp_path),
                            metric="euclidean", bucket_cap=16,
                            injector=inj).build(tb.torch_cp(corpus))
    svc.delete(np.array([4]))
    before = [open(p, "rb").read() for p in _wal_paths(tmp_path)]
    fired = list(inj.fired)
    with pytest.raises(TypeError, match="R6"):
        svc.insert(tb.torch_cp([f[:3] for f in corpus]))
    assert inj.fired == fired                 # pre_wal_append never fired
    assert [open(p, "rb").read() for p in _wal_paths(tmp_path)] == before
    assert svc.health == "serving" and svc.index.size == 60
    assert [k for _, k, _ in read_wal(str(tmp_path))[0]] == ["delete"]


def test_snapshot_skeleton_naming_another_class_is_refused(tmp_path):
    corpus, _ = tb.cp_fixture(61, 5)
    ref = _jax_durable(tmp_path).build(tb.jax_cp(corpus))
    ref.close()
    path = tmp_path / "snap_000000000000" / "manifest.json"
    manifest = json.load(open(path))
    skeleton = pickle.loads(base64.b64decode(
        manifest["segments"][0]["corpus_skeleton"]))
    assert type(skeleton).__module__ == "repro.core.tensor_formats"
    manifest["segments"][0]["corpus_skeleton"] = base64.b64encode(
        pickle.dumps(functools.partial(print, "x"))).decode()
    json.dump(manifest, open(path, "w"))
    svc = DurableLSHService(tb.bridge_family(_jax_family()), str(tmp_path),
                            metric="euclidean", bucket_cap=16,
                            max_deltas=64)
    with pytest.raises(RecoveryError, match="functools.partial"):
        svc.recover()
    assert svc.health == "degraded"


# ---------------------------------------------------------------------------
# The reference reads the port's directories (ROADMAP.md F4)
# ---------------------------------------------------------------------------


def _assert_reference_answers_as_port(ref, svc, tq, jq):
    """The reference's recovered answers against the port's live ones,
    within the parity contract (``_assert_answers_as_reference``'s checks
    with the roles of the two services swapped)."""
    ids, sc, nc = (np.array(a) for a in ref.query_arrays(jq, topk=TOPK))
    pi, ps, pn = svc.query_arrays(tq, topk=TOPK)
    clean = ~_near_rows(svc.index.family, tq)
    assert clean.any()
    np.testing.assert_array_equal(nc[clean], pn[clean])
    tol = parity.rerank_bound("euclidean", tq, svc.index.effective_corpus(),
                              torch.from_numpy(pi), torch.from_numpy(ps))
    rows = torch.from_numpy(clean)
    assert parity.topk_mismatches(
        torch.from_numpy(ids)[rows], torch.from_numpy(sc)[rows],
        torch.from_numpy(pi)[rows], torch.from_numpy(ps)[rows],
        tol[rows]) == 0


@pytest.mark.parametrize("shards", [None, 2])
def test_reference_recovers_a_dense_port_directory(tmp_path, shards):
    """67 dense items, an insert, deletes, a compact and an insert written
    by the port; the reference's ``recover()`` reads the directory (its
    ``corpus_skeleton`` the bare placeholder) and answers as the port's
    live service."""
    svc = _durable(tmp_path, shards=shards)
    for op in _fixed_ops()[:5]:
        _apply(svc, op)
    svc.close()
    manifest = json.load(open(tmp_path / "snap_000000000000" /
                              "manifest.json"))
    for entry in manifest["segments"]:
        assert pickle.loads(base64.b64decode(
            entry["corpus_skeleton"])) == "__leaf__"
    ref = _jax_durable(tmp_path, shards).recover()
    assert ref.stats.recoveries == 1
    assert ref.index.size == svc.index.size == N_CORPUS + 5 - 2 + 4 + 3
    _assert_reference_answers_as_port(ref, svc, as_batch(_queries()),
                                      _data()[1])


@pytest.mark.parametrize("layout", ["cp", "tt"])
def test_reference_recovers_cp_and_tt_port_directories(tmp_path, layout):
    """A CP / TT corpus (scale 0.5) with deletes and a compact, written by
    the port: the skeleton is the reference's ``CPTensor`` / ``TTTensor``
    of placeholders, byte for byte the pickle the reference writes for
    that corpus, with the reference skeleton's tree structure; the
    reference's ``recover()`` answers as the port's live service."""
    from repro.core import tensor_formats as jtf
    kind = f"{layout}-e2lsh"
    fx, jwrap, twrap = ((tb.cp_fixture, tb.jax_cp, tb.torch_cp)
                        if layout == "cp" else
                        (tb.tt_fixture, tb.jax_tt, tb.torch_tt))
    corpus, queries = fx(61, 5)
    fam = _jax_family(kind)
    svc = DurableLSHService(tb.bridge_family(fam), str(tmp_path),
                            metric="euclidean", bucket_cap=16,
                            max_deltas=64).build(twrap(corpus, 0.5))
    svc.delete(np.array([2, 9, 30]))
    svc.compact()
    svc.delete(np.array([1, 40]))
    svc.snapshot()
    svc.close()
    lsn = latest_snapshot(str(tmp_path))
    manifest = json.load(open(tmp_path / f"snap_{lsn:012d}" /
                              "manifest.json"))
    raw = base64.b64decode(manifest["segments"][0]["corpus_skeleton"])
    n_modes = len(corpus)
    cls, field = ((jtf.CPTensor, "factors") if layout == "cp"
                  else (jtf.TTTensor, "cores"))
    want = cls(**{field: ("__leaf__",) * n_modes, "scale": 0.5})
    assert raw == pickle.dumps(want)
    assert (jax.tree_util.tree_structure(pickle.loads(raw))
            == jax.tree_util.tree_structure(want))
    ref = _jax_durable(tmp_path, family=fam).recover()
    assert ref.index.size == svc.index.size == 56
    np.testing.assert_array_equal(np.asarray(ref.index.store.base.keys)
                                  .astype(np.int64),
                                  svc.index.store.base.keys.numpy())
    _assert_reference_answers_as_port(ref, svc, twrap(queries, 0.5),
                                      jwrap(queries, 0.5))


def test_port_reads_its_own_skeleton(tmp_path):
    """Without ``corpus_format`` the port's ``load_snapshot`` falls back to
    the skeleton it wrote (through ``_SkeletonUnpickler``) and recovers
    bit for bit."""
    corpus, _ = tb.tt_fixture(61, 5)
    fam = tb.bridge_family(_jax_family("tt-e2lsh"))
    svc = DurableLSHService(fam, str(tmp_path), metric="euclidean",
                            bucket_cap=16).build(tb.torch_tt(corpus, 0.5))
    svc.delete(np.array([3, 7]))
    svc.close()
    path = tmp_path / "snap_000000000000" / "manifest.json"
    manifest = json.load(open(path))
    for entry in manifest["segments"]:
        del entry["corpus_format"]
    json.dump(manifest, open(path, "w"))
    rec = DurableLSHService(fam, str(tmp_path), metric="euclidean",
                            bucket_cap=16).recover()
    assert rec.index.effective_corpus().scale == 0.5
    _assert_bit_identical(rec, svc, tb.torch_tt(corpus, 0.5).index(
        slice(0, 4)))
