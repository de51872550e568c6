"""The typed errors and the fault injector of the durability plane
(reference: ``repro.serving.durability``).

The serving scheduler (``serving.scheduler``) retries ``TransientIOError``
on its ingest lane, degrades a namespace on exhausted retries or an
``InjectedCrash``, and sheds requests to a degraded namespace with
``ServiceUnavailable``. ``FaultInjector`` arms those failures at named
boundaries for the tests. The write-ahead log, the snapshots,
``DurableLSHService`` and ``recover()`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations


# ---------------------------------------------------------------------------
# Typed errors
# ---------------------------------------------------------------------------


class DurabilityError(RuntimeError):
    """Base of the durability error family."""


class WalCorrupted(DurabilityError):
    """The WAL is damaged before its tail (bad checksum, truncated frame
    in a non-final segment, lsn discontinuity): replay refuses to build
    a silently partial store."""


class RecoveryError(DurabilityError):
    """Recovery cannot produce a consistent store (no complete snapshot,
    config mismatch, snapshot corruption, missing log suffix)."""


class TransientIOError(OSError):
    """A retryable IO failure on the durability plane: the scheduler's
    ingest lane retries these with bounded exponential backoff."""


class ServiceUnavailable(RuntimeError):
    """The namespace is degraded or recovering; the request was shed
    instead of served from a possibly inconsistent store."""


class InjectedCrash(RuntimeError):
    """A ``FaultInjector`` crash point fired: stands in for process death
    in the chaos tests (state past the fired boundary is lost)."""


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------


CRASH_POINTS = ("pre_wal_append", "post_wal_append", "mid_snapshot",
                "pre_apply_swap")


class FaultInjector:
    """Armable faults at the named durability boundaries.

    ``crash_at(point, after=k)`` raises ``InjectedCrash`` the (k+1)-th
    time ``point`` fires (then disarms); ``fail_transient(point, times)``
    raises ``TransientIOError`` the next ``times`` firings (the retry
    path's test hook). ``fired`` records every firing in order.
    """

    def __init__(self):
        self._crash: dict[str, int] = {}
        self._transient: dict[str, int] = {}
        self.fired: list[str] = []

    @staticmethod
    def _check(point: str) -> None:
        if point not in CRASH_POINTS:
            raise ValueError(f"unknown crash point {point!r}; expected one "
                             f"of {CRASH_POINTS}")

    def crash_at(self, point: str, after: int = 0) -> "FaultInjector":
        self._check(point)
        self._crash[point] = int(after)
        return self

    def fail_transient(self, point: str, times: int = 1) -> "FaultInjector":
        self._check(point)
        self._transient[point] = int(times)
        return self

    def fire(self, point: str) -> None:
        self.fired.append(point)
        left = self._transient.get(point, 0)
        if left > 0:
            self._transient[point] = left - 1
            raise TransientIOError(
                f"injected transient IO failure at {point!r}")
        if point in self._crash:
            if self._crash[point] > 0:
                self._crash[point] -= 1
            else:
                del self._crash[point]
                raise InjectedCrash(f"injected crash at {point!r}")
