"""Two-lane micro-batch request scheduler and multi-tenant namespaces for
``LSHService`` (reference: ``repro.serving.scheduler``): the serving plane
where mutations never stall queries.

Single queries are the worst case for the query path: a batch of one pays
the same launch overhead as a batch of a thousand and none of the batch
economics. The scheduler closes the gap by *coalescing*: the query lane
gathers compatible single-query requests into one micro-batch and
dispatches on whichever comes first, the latency deadline
(``deadline_ms``, measured from the oldest queued request) or the size cap
(``max_batch``). Requests coalesce only within a group key (tenant, topk,
probes, mode), and sampling requests never coalesce (each carries its own
seed, i.e. its own draw). A group of b requests is stacked
(``tensor_formats.stack_items``) and runs as one ``query_arrays`` batch of
b rows. It is not padded: the reference pads to a power of two so that
jit's program cache holds few shapes, and the port has no such cache (K1's
and K3's launch plans do not depend on the batch size). ``stat_rows``
still carries the group's request count, so the tenant's counters count
requests exactly.

Two lanes, one rule: the *query lane* only reads published stores, the
*ingest lane* owns every mutation. ``insert`` / ``delete`` run on the
ingest lane directly; ``compact`` / ``rebalance`` run there as the
double-buffered pair: ``prepare_*`` builds the replacement store (the slow
part, chunked and throttled, off the query path) and ``apply_swap``
publishes it as a pointer flip. Because the ingest lane serializes all
mutations, the swap's generation guard never fires in normal operation;
the query lane keeps dispatching throughout and each query answers from
the store generation it read.

On the card each lane has its own CUDA stream on each card its tenants
use: the query lane a stream of the highest priority, the ingest lane a
stream of the default priority (neither is the legacy default stream).
The kernel wrappers launch on the current stream, so a lane's kernels run
on its stream, and the card runs query kernels ahead of queued build work.
Each lane synchronizes only its own stream (``core.index``'s syncs, the
build steps, the results' copy to the host). Three orderings cross the
streams:

* registration: both streams wait on the registering thread's current
  stream, so everything queued to build a service precedes the lanes;
* publication: a store's view carries an event recorded on the ingest
  stream after its last upload, and the query lane's stream waits on it
  before it reads the view (``StoreView.acquire``);
* lifetime: ``acquire`` also marks the view's arrays as used on the query
  stream (``Tensor.record_stream``), so when ``apply_swap`` drops the old
  store, or a mutation supersedes a view, the caching allocator reuses
  that memory only after the queries queued on the query stream have run.
  An item submitted on the card carries its submitter's current stream;
  before a group reads its items, the lane's stream waits for the work
  queued on each distinct submitter stream so far (``wait_stream``: one
  event a stream and group, not one a request), which includes the work
  that made the items.

*Namespaces* multiplex many logical indexes (one ``LSHService`` each)
behind one scheduler and one pair of lanes. ``TenantQuota`` bounds each
tenant at admission: ``max_items`` caps the live corpus (oversized inserts
are rejected before they queue), ``max_pending`` caps queued requests
(backpressure). Rejections raise ``QuotaExceeded`` at submission and count
into that tenant's ``ServiceStats.rejected``; per-tenant traffic counters
are the tenant's own ``ServiceStats``.

Every submission returns a ``concurrent.futures.Future``; exceptions (bad
overrides, service errors, a kernel that fails on a lane) resolve through
it. ``flush()`` drains both lanes (and raises ``TimeoutError`` rather than
letting a stalled lane read as drained); the scheduler is a context
manager (``close()`` stops the lanes).

*Robustness*: the ingest lane retries transient IO failures
(``durability.TransientIOError``) with bounded exponential backoff and
records terminal failures on both the scheduler's and the tenant's stats
(``errors`` / ``last_error``): a dropped future never silently swallows a
failed mutation. Exhausted retries or an injected crash mark the namespace
``"degraded"``; a degraded or recovering namespace sheds every request
with a typed ``ServiceUnavailable`` at submission instead of hanging,
until ``recover_namespace()`` replays the tenant's durable state back to
``"serving"``: a ``durability.DurableLSHService`` tenant's ``recover()``
runs on the ingest lane, so the recovery's uploads and its view's flip
are made on the ingest stream and the query lane orders itself after them
through ``StoreView.acquire``; on a plain ``LSHService`` it raises the
reference's ``TypeError``.
``request_timeout_ms`` expires requests that sat queued too long with a
``RequestTimeout``.

The lanes are Python threads: a full collection of the interpreter's
garbage collector stops them both. On a heap holding the built services
and PyTorch one full collection took 107-147 ms on the H100's host, which
set the open-loop p99 (PERF.md); a serving process calls ``gc.freeze()``
once its services are built, as ``chip_smoke.py``'s [sched] does, so that
full collections scan only what serving allocates.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue as queue_lib
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Callable

import torch

from repro_torch.core import segments
from repro_torch.core.tensor_formats import as_batch, stack_items
from repro_torch.serving.durability import (InjectedCrash, ServiceUnavailable,
                                            TransientIOError)
from repro_torch.serving.lsh_service import LSHService

QUERY_LANE = "lsh-query-lane"      # the lanes' thread names, which the
INGEST_LANE = "lsh-ingest-lane"    # kernel wrappers' ``lanes`` counts use
# the query stream's priority: lower numbers are higher priorities, and
# PyTorch maps one past the card's range to its highest
_QUERY_PRIORITY = -(1 << 10)


class QuotaExceeded(RuntimeError):
    """A tenant quota refused this request at admission."""


class RequestTimeout(TimeoutError):
    """The request sat queued past ``request_timeout_ms``; its future
    resolves with this instead of running against state the caller has
    long stopped waiting for."""


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Admission limits for one namespace (None = unlimited).

    ``max_items`` caps the tenant's live corpus: an insert that would grow
    past it is rejected at submission. ``max_pending`` caps the tenant's
    queued-but-unserved requests across both lanes: the backpressure
    valve that keeps one tenant from monopolizing the lanes."""

    max_items: int | None = None
    max_pending: int | None = None


@dataclasses.dataclass
class SchedulerStats:
    """Query-lane coalescing counters (per scheduler, across tenants)."""

    requests: int = 0          # single-query submissions served
    batches: int = 0           # query_arrays batches on the query lane
    size_flushes: int = 0      # batches flushed by the max_batch cap
    deadline_flushes: int = 0  # batches flushed by the latency deadline
    errors: int = 0            # ingest-lane mutations that failed for good
    last_error: str = ""       # "<Type>: <message>" of the newest failure
    retries: int = 0           # ingest re-runs after transient IO failures
    timeouts: int = 0          # requests expired past request_timeout_ms
    shed: int = 0              # requests refused on a non-serving namespace

    @property
    def mean_batch(self) -> float:
        """Mean coalesced batch size (1.0 = no coalescing happened)."""
        return self.requests / max(self.batches, 1)

    def reset(self) -> None:
        """Zero the counters (e.g. after a warm-up / calibration burst)."""
        self.requests = self.batches = 0
        self.size_flushes = self.deadline_flushes = 0
        self.errors = self.retries = self.timeouts = self.shed = 0
        self.last_error = ""


@dataclasses.dataclass
class _Namespace:
    name: str
    service: LSHService
    quota: TenantQuota
    pending: int = 0           # admitted, not yet completed requests


@dataclasses.dataclass
class _QueryReq:
    ns: _Namespace
    x: Any                     # one item (no batch dim)
    topk: int
    probes: int | None
    mode: str | None
    seed: int | None
    future: Future
    t_submit: float
    ready: Any = None          # the submitter's stream (card items)

    @property
    def group_key(self):
        # sampling modes carry per-request seeds (independent draws) and
        # never coalesce; id(self) makes the key unique
        mode = self.mode
        if mode in ("uniform", "weighted"):
            return (id(self),)
        return (self.ns.name, self.topk, self.probes, mode)


@dataclasses.dataclass
class _IngestReq:
    ns: _Namespace
    fn: Callable
    future: Future
    t_submit: float
    ready: Any = None          # the submitter's stream (card items)


_STOP = object()


def _submitted(x):
    """The current stream of the card ``x`` lies on (None for an item on
    the CPU): the lane that reads ``x`` first waits for the work queued on
    it."""
    leaves = (x,) if isinstance(x, torch.Tensor) else getattr(x, "leaves",
                                                              ())
    for leaf in leaves:
        if leaf.device.type == "cuda":
            return torch.cuda.current_stream(leaf.device)
    return None


class ServingScheduler:
    """Serve one or many ``LSHService`` namespaces through two lanes.

    ``services``: a single service (namespace ``"default"``) or a
    ``{name: service}`` dict. ``quotas``: optional ``{name: TenantQuota}``.
    ``max_batch``: query-lane size flush (coalesced batch cap).
    ``deadline_ms``: query-lane latency deadline: the oldest queued
    request waits at most this long before its batch dispatches.
    ``request_timeout_ms``: requests still queued past this age resolve
    with ``RequestTimeout`` instead of running (None = never expire).
    ``ingest_retries`` / ``retry_backoff_ms``: the ingest lane re-runs a
    mutation that failed with a *transient* IO error
    (``durability.TransientIOError``) up to ``ingest_retries`` times with
    exponential backoff (capped at 1 s); exhausting the retries, or an
    ``InjectedCrash``, marks the namespace ``"degraded"``, after which
    requests shed with ``ServiceUnavailable`` until
    ``recover_namespace()`` brings it back. Tenants on the card get the
    lanes' streams (``streams``) when they are registered.
    """

    def __init__(self, services, *, max_batch: int = 64,
                 deadline_ms: float = 2.0,
                 quotas: dict[str, TenantQuota] | None = None,
                 request_timeout_ms: float | None = None,
                 ingest_retries: int = 3,
                 retry_backoff_ms: float = 10.0):
        if int(max_batch) < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if float(deadline_ms) < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {deadline_ms}")
        if int(ingest_retries) < 0:
            raise ValueError(
                f"ingest_retries must be >= 0, got {ingest_retries}")
        if isinstance(services, LSHService):
            services = {"default": services}
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_ms) / 1e3
        self.timeout_s = (None if request_timeout_ms is None
                          else float(request_timeout_ms) / 1e3)
        self.ingest_retries = int(ingest_retries)
        self.backoff_s = float(retry_backoff_ms) / 1e3
        self.stats = SchedulerStats()
        self.streams: dict[torch.device, tuple] = {}  # card -> (query,
                                                      # ingest) streams
        self._namespaces: dict[str, _Namespace] = {}
        self._lock = threading.Lock()
        quotas = quotas or {}
        for name, svc in services.items():
            self.add_namespace(name, svc, quota=quotas.get(name))
        self._query_q: queue_lib.Queue = queue_lib.Queue()
        self._ingest_q: queue_lib.Queue = queue_lib.Queue()
        self._queries_inflight = 0   # submitted, future not yet resolved
        self._closed = False
        self._query_thread = threading.Thread(
            target=self._query_loop, name=QUERY_LANE, daemon=True)
        self._ingest_thread = threading.Thread(
            target=self._ingest_loop, name=INGEST_LANE, daemon=True)
        self._query_thread.start()
        self._ingest_thread.start()

    # -- namespaces ---------------------------------------------------------

    def add_namespace(self, name: str, service: LSHService,
                      quota: TenantQuota | None = None) -> None:
        """Register a logical index under ``name``. On the card, both lanes'
        streams wait for the work queued so far on the caller's current
        stream (the service's build)."""
        if name in self._namespaces:
            raise ValueError(f"namespace {name!r} already registered")
        dev = service.device
        if dev.type == "cuda":
            if dev not in self.streams:
                self.streams[dev] = (
                    torch.cuda.Stream(dev, priority=_QUERY_PRIORITY),
                    torch.cuda.Stream(dev))
            caller = torch.cuda.current_stream(dev)
            for stream in self.streams[dev]:
                stream.wait_stream(caller)
        self._namespaces[name] = _Namespace(
            name=name, service=service, quota=quota or TenantQuota())

    def namespaces(self) -> tuple[str, ...]:
        return tuple(self._namespaces)

    def service(self, tenant: str = "default") -> LSHService:
        return self._ns(tenant).service

    def tenant_stats(self, tenant: str = "default"):
        """The tenant's ``ServiceStats`` (its per-tenant counters)."""
        return self._ns(tenant).service.stats

    def _ns(self, tenant: str) -> _Namespace:
        ns = self._namespaces.get(tenant)
        if ns is None:
            raise KeyError(
                f"unknown namespace {tenant!r}; registered: "
                f"{sorted(self._namespaces)}")
        return ns

    def _lane(self, ns: _Namespace, lane: int, submitters=()):
        """The context a lane runs ``ns``'s work in: on the card, the
        lane's stream (0 query, 1 ingest), made to wait for the work queued
        so far on each distinct stream of ``submitters``; on the CPU,
        nothing."""
        dev = ns.service.device
        if dev.type != "cuda":
            return contextlib.nullcontext()
        stream = self.streams[dev][lane]
        waited = set()
        for other in submitters:
            if other is not None and other.cuda_stream not in waited:
                stream.wait_stream(other)
                waited.add(other.cuda_stream)
        return torch.cuda.stream(stream)

    def _admit(self, ns: _Namespace, new_items: int = 0) -> None:
        with self._lock:
            q = ns.quota
            if q.max_pending is not None and ns.pending >= q.max_pending:
                ns.service.stats.rejected += 1
                raise QuotaExceeded(
                    f"tenant {ns.name!r} has {ns.pending} pending requests "
                    f"(max_pending={q.max_pending})")
            if (new_items and q.max_items is not None
                    and ns.service.index.size + new_items > q.max_items):
                ns.service.stats.rejected += 1
                raise QuotaExceeded(
                    f"insert of {new_items} items would grow tenant "
                    f"{ns.name!r} past max_items={q.max_items} "
                    f"(live={ns.service.index.size})")
            ns.pending += 1

    def _done(self, ns: _Namespace, future: Future) -> Future:
        def _dec(_):
            with self._lock:
                ns.pending -= 1
        future.add_done_callback(_dec)
        return future

    # -- health -------------------------------------------------------------

    def _shed_unless_serving(self, ns: _Namespace) -> None:
        """Degraded-mode serving: a non-serving namespace sheds at
        submission with a typed error instead of queueing work that would
        hang or run against an inconsistent store."""
        health = getattr(ns.service, "health", "serving")
        if health != "serving":
            ns.service.stats.unavailable += 1
            self.stats.shed += 1
            raise ServiceUnavailable(
                f"namespace {ns.name!r} is {health!r}; request shed "
                "(recover_namespace() restores it)")

    def _set_health(self, ns: _Namespace, health: str) -> None:
        ns.service.health = health

    def _record_error(self, ns: _Namespace, exc: BaseException) -> None:
        msg = f"{type(exc).__name__}: {exc}"
        self.stats.errors += 1
        self.stats.last_error = msg
        ns.service.stats.errors += 1
        ns.service.stats.last_error = msg

    def recover_namespace(self, tenant: str = "default") -> Future:
        """Queue a snapshot+replay recovery of a degraded durable tenant
        on the ingest lane (bypasses health shedding: this is the one
        request a non-serving namespace must accept). Resolves to the
        service once it is back to ``"serving"``."""
        ns = self._ns(tenant)
        self._check_open()
        recover = getattr(ns.service, "recover", None)
        if recover is None:
            raise TypeError(
                f"namespace {ns.name!r} serves a non-durable service; "
                "recovery needs a DurableLSHService")
        self._admit(ns)
        return self._submit_ingest(ns, recover)

    # -- submission API -----------------------------------------------------

    def query(self, x, *, tenant: str = "default", topk: int = 10,
              probes: int | None = None, mode: str | None = None,
              seed: int | None = None) -> Future:
        """Submit ONE query (no batch dim) for coalescing; the future
        resolves to (ids (topk,), scores (topk,), n_candidates) with -1
        fill, exactly one row of ``LSHService.query_arrays``."""
        ns = self._ns(tenant)
        self._check_open()
        self._shed_unless_serving(ns)
        self._admit(ns)
        req = _QueryReq(ns=ns, x=x, topk=int(topk), probes=probes,
                        mode=mode, seed=seed, future=Future(),
                        t_submit=time.perf_counter(), ready=_submitted(x))
        with self._lock:
            self._queries_inflight += 1
        req.future.add_done_callback(self._query_resolved)
        self._query_q.put(req)
        return self._done(ns, req.future)

    def _query_resolved(self, _future) -> None:
        with self._lock:
            self._queries_inflight -= 1

    def _queries_waiting(self) -> bool:
        """Any query submitted but not yet resolved: the ingest lane's cue
        to cede the host between build steps."""
        return self._queries_inflight > 0

    def insert(self, batch, *, tenant: str = "default") -> Future:
        """Submit an insert to the ingest lane; resolves to the service."""
        ns = self._ns(tenant)
        self._check_open()
        self._shed_unless_serving(ns)
        n = as_batch(batch).leaves[0].shape[0]
        self._admit(ns, new_items=n)
        return self._submit_ingest(ns, lambda: ns.service.insert(batch),
                                   _submitted(batch))

    def delete(self, ids, *, tenant: str = "default") -> Future:
        """Submit a delete to the ingest lane; resolves to the count."""
        ns = self._ns(tenant)
        self._check_open()
        self._shed_unless_serving(ns)
        self._admit(ns)
        return self._submit_ingest(ns, lambda: ns.service.delete(ids),
                                   _submitted(ids))

    def compact(self, tenant: str = "default") -> Future:
        """Queue a compaction on the ingest lane: the replacement store is
        built there (off the query path) and published as a pointer flip;
        queries keep flowing the whole time."""
        ns = self._ns(tenant)
        self._check_open()
        self._shed_unless_serving(ns)
        self._admit(ns)
        return self._submit_ingest(
            ns, lambda: ns.service.apply_swap(ns.service.prepare_compact()))

    def rebalance(self, tenant: str = "default") -> Future:
        """Queue a rebalance (sharded tenants): the same prepare / flip
        split."""
        ns = self._ns(tenant)
        self._check_open()
        self._shed_unless_serving(ns)
        self._admit(ns)
        return self._submit_ingest(
            ns,
            lambda: ns.service.apply_swap(ns.service.prepare_rebalance()))

    def _submit_ingest(self, ns: _Namespace, fn, ready=None) -> Future:
        req = _IngestReq(ns=ns, fn=fn, future=Future(),
                         t_submit=time.perf_counter(), ready=ready)
        self._ingest_q.put(req)
        return self._done(ns, req.future)

    def flush(self, timeout: float | None = None) -> None:
        """Block until everything submitted so far has executed. Raises
        ``TimeoutError`` when the lanes have not drained within
        ``timeout`` seconds (one shared deadline across both): a stalled
        lane must never read as a drained one."""
        deadline = (None if timeout is None
                    else time.perf_counter() + float(timeout))
        barriers = []
        for q in (self._query_q, self._ingest_q):
            f: Future = Future()
            q.put((lambda: None, f))
            barriers.append(f)
        for f in barriers:
            left = (None if deadline is None
                    else max(deadline - time.perf_counter(), 0.0))
            try:
                f.result(timeout=left)
            except _FutureTimeout:
                raise TimeoutError(
                    f"flush timed out after {timeout}s with work still "
                    "queued on the lanes") from None

    def close(self) -> None:
        """Drain both lanes and stop their threads."""
        if self._closed:
            return
        self._closed = True
        self._query_q.put(_STOP)
        self._ingest_q.put(_STOP)
        self._query_thread.join()
        self._ingest_thread.join()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("scheduler is closed")

    def __enter__(self) -> "ServingScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- lanes --------------------------------------------------------------

    def _query_loop(self) -> None:
        stop = False
        while not stop:
            item = self._query_q.get()
            if item is _STOP:
                return
            if isinstance(item, tuple):     # flush barrier
                item[1].set_result(None)
                continue
            batch, deferred = [item], []
            deadline = item.t_submit + self.deadline_s
            flush_kind = "deadline"
            while len(batch) < self.max_batch:
                try:
                    # drain whatever is already queued without waiting:
                    # when the lane falls behind, the backlog coalesces
                    # into one batch even though the oldest request's
                    # deadline has long passed
                    nxt = self._query_q.get_nowait()
                except queue_lib.Empty:
                    timeout = deadline - time.perf_counter()
                    if timeout <= 0:
                        break
                    try:
                        nxt = self._query_q.get(timeout=timeout)
                    except queue_lib.Empty:
                        break
                if nxt is _STOP:
                    stop = True
                    break
                if isinstance(nxt, tuple):  # barrier: resolve after batch
                    deferred.append(nxt[1])
                    continue
                batch.append(nxt)
            else:
                flush_kind = "size"
            self._run_batch(batch, flush_kind)
            for f in deferred:
                f.set_result(None)

    def _run_batch(self, batch: list[_QueryReq], flush_kind: str) -> None:
        groups: dict[Any, list[_QueryReq]] = {}
        for req in batch:
            groups.setdefault(req.group_key, []).append(req)
        self.stats.requests += len(batch)
        self.stats.batches += len(groups)
        if flush_kind == "size":
            self.stats.size_flushes += 1
        else:
            self.stats.deadline_flushes += 1
        for reqs in groups.values():
            self._run_group(reqs)

    def _expire(self, req) -> None:
        self.stats.timeouts += 1
        req.ns.service.stats.timeouts += 1
        req.future.set_exception(RequestTimeout(
            f"request queued for more than "
            f"{self.timeout_s * 1e3:g} ms (request_timeout_ms)"))

    def _run_group(self, reqs: list[_QueryReq]) -> None:
        if self.timeout_s is not None:
            now, live = time.perf_counter(), []
            for req in reqs:
                if now - req.t_submit > self.timeout_s:
                    self._expire(req)
                else:
                    live.append(req)
            reqs = live
            if not reqs:
                return
        head = reqs[0]
        try:
            # the requests (and so their items) stay referenced until the
            # results are on the host, after the query stream's work
            with self._lane(head.ns, 0, [r.ready for r in reqs]):
                ids, scores, n_cand = head.ns.service.query_arrays(
                    stack_items([r.x for r in reqs]), topk=head.topk,
                    probes=head.probes, mode=head.mode, seed=head.seed,
                    stat_rows=len(reqs))
            for i, req in enumerate(reqs):
                req.future.set_result(
                    (ids[i], scores[i], int(n_cand[i])))
        except Exception as exc:  # resolve every waiter, never wedge
            for req in reqs:
                if not req.future.done():
                    req.future.set_exception(exc)

    def _ingest_loop(self) -> None:
        while True:
            item = self._ingest_q.get()
            if item is _STOP:
                return
            if isinstance(item, tuple):     # flush barrier
                item[1].set_result(None)
                continue
            self._run_ingest(item)

    def _run_ingest(self, req: _IngestReq) -> None:
        if (self.timeout_s is not None
                and time.perf_counter() - req.t_submit > self.timeout_s):
            self._expire(req)
            return
        attempt = 0
        while True:
            try:
                # mutations on this lane run cooperatively: the throttled
                # store-build loops yield the host between bounded steps,
                # but only while a query is in flight, so a pending
                # query-lane batch runs with most of the host instead of
                # convoying behind the whole build
                with self._lane(req.ns, 1, [req.ready]), \
                        segments.cooperative_build(
                            busy=self._queries_waiting):
                    req.future.set_result(req.fn())
                return
            except TransientIOError as exc:
                # retryable IO on the durability plane: nothing was
                # committed, so re-running the mutation is safe
                if attempt >= self.ingest_retries:
                    self._record_error(req.ns, exc)
                    self._set_health(req.ns, "degraded")
                    req.future.set_exception(exc)
                    return
                attempt += 1
                self.stats.retries += 1
                req.ns.service.stats.retries += 1
                time.sleep(min(self.backoff_s * 2 ** (attempt - 1), 1.0))
            except Exception as exc:
                # non-retryable: record it on the tenant so a dropped
                # future can't swallow a failed mutation; a simulated
                # crash leaves memory state untrusted -> degrade
                self._record_error(req.ns, exc)
                if isinstance(exc, InjectedCrash):
                    self._set_health(req.ns, "degraded")
                req.future.set_exception(exc)
                return
