"""Launch counts of the kernel wrappers, kept right across threads.

Every wrapper carries ``launches`` (an int) and ``lanes`` (a
``collections.Counter`` by the launching thread's name: the serving
scheduler's ``"lsh-query-lane"`` and ``"lsh-ingest-lane"``, or the caller's
own thread). ``count_launch`` adds one to both, and to a K1 wrapper's
``branches``, under one lock: the scheduler's two lanes launch K3 at the
same time, and a read-modify-write of a plain attribute from two threads
can lose a count.
"""

from __future__ import annotations

import collections
import threading

LOCK = threading.Lock()


def counted(fn):
    """Give a wrapper its zeroed ``launches`` and ``lanes``."""
    fn.launches = 0
    fn.lanes = collections.Counter()
    return fn


def count_launch(fn, branches=None) -> None:
    """One launch of ``fn``'s kernel by the current thread (and the K1
    ``branches`` it ran)."""
    with LOCK:
        fn.launches += 1
        fn.lanes[threading.current_thread().name] += 1
        if branches:
            fn.branches.update(branches)
