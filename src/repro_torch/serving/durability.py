"""Durability for the mutable index: write-ahead mutation log, atomic
snapshots, crash-point fault injection, and snapshot+replay recovery
(reference: ``repro.serving.durability``).

A served index's durable identity is small: the family config and the
mutation history. ``DurableLSHService`` wraps every mutation of
``LSHService`` in a write-ahead commit:

* **WAL** (``MutationLog``): an append-only log of mutation records: insert
  batches (the raw dense items; replay re-hashes them), delete id-sets, and
  compact / rebalance epoch markers. Records are framed ``[u32 length][u32
  crc32-of-head][head][raw blobs]`` (each blob carries a 64-bit xor-fold in
  the head) at 4 KiB-aligned offsets in preallocated, prezeroed segments,
  written ``O_DIRECT`` + ``fdatasync`` where the filesystem allows
  (buffered + ``fdatasync`` otherwise) on a committer thread that overlaps
  the apply. The committer touches numpy arrays and the file only, never a
  tensor: the caller makes the one host copy of a batch, on its current
  stream, before the commit begins. A mutation returns only after both the
  sync and the apply complete, so an operation is committed iff its append
  completed, and a failed apply cancels its record. A torn tail (a final
  record damaged by a crash mid-append) is dropped on replay; the same
  damage with intact records after it raises ``WalCorrupted``. For the
  same operations the segment files are byte for byte the reference's.
* **Snapshots**: atomic dumps of the ``SegmentStore`` (segment arrays +
  ``host_state()``) into a temp directory with a per-array crc32 manifest,
  fsync'd and published by one ``os.rename``, so a crash mid-snapshot never
  corrupts the last complete one. Keys are written as uint32, perms as
  int32 and the corpus in the reference's leaf order and shapes; the port
  writes its corpus format as JSON (``corpus_format``) and reads either
  that or the reference's pickled skeleton, through an unpickler that
  admits the reference's ``CPTensor`` / ``TTTensor`` names only. On the
  card the copies to the host run on the current stream and synchronize
  only it. Each snapshot rotates the WAL; older segments and snapshots are
  pruned.
* **Recovery** (``recover()``): restore the latest complete snapshot (the
  kernels' stacked layout rebuilt by the builds' own ``stack``, the corpus
  leaves its views), replay the WAL suffix. The mutation plane is
  deterministic (the hash, the water-fill routing, sequence-order effective
  ids, stable sorts), so the recovered store answers queries bit for bit
  as the uninterrupted process. ``max_deltas`` auto-compactions are not
  logged: replayed inserts trigger them at the same points.
* **Fault injection** (``FaultInjector``): named crash points at every
  durability boundary (``pre_wal_append`` / ``post_wal_append`` either side
  of the commit, ``mid_snapshot`` between the array dump and the rename,
  ``pre_apply_swap`` between the epoch marker's commit and the flip), and
  armable transient IO failures (``TransientIOError``) that the serving
  scheduler's ingest lane retries.

Insert records hold dense batches only, as the reference's do: its
``np.asarray`` of a batched CP or TT tensor is no array (ROADMAP.md, R6).
A CP or TT insert into a durable service raises ``TypeError`` before
anything is written; CP and TT corpora are snapshotted, and their deletes
and epoch markers logged, as dense ones.

Health states: ``"cold"`` (constructed), ``"serving"``, ``"recovering"``
(inside ``recover()``), ``"degraded"`` (a recovery failed, or the scheduler
marked the namespace down after exhausting retries). Any request against a
non-serving durable service raises the typed ``ServiceUnavailable``.
"""

from __future__ import annotations

import base64
import io
import itertools
import json
import mmap
import os
import pickle
import re
import shutil
import struct
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from repro_torch.convert import segment_from_numpy
from repro_torch.core.index import ShardedLSHIndex
from repro_torch.core.segments import SegmentStore, ShardedSegment
from repro_torch.core.tensor_formats import CPTensor, DenseTensor, TTTensor
from repro_torch.serving.lsh_service import LSHService


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


# ---------------------------------------------------------------------------
# Record payloads: one array (or nothing) <-> bytes
# ---------------------------------------------------------------------------

# A record payload is one JSON head (skeleton, per-leaf dtype / shape /
# byte length / fold, lsn, kind, in the reference's key order) followed by
# the leaves as concatenated raw little-endian blobs. A record holds one
# ndarray (insert items, delete ids) or None (an epoch marker); the
# reference pickles its pytree skeleton, which for one array is the bare
# placeholder string, so the port writes ``pickle.dumps(_LEAF)`` and its
# records are the reference's byte for byte.
#
# Integrity is two-tier: the frame's crc32 covers only the (small) head
# section, and each blob carries a 64-bit xor-fold: one streaming pass
# instead of a crc over megabytes of items, still flipping on any single
# damaged burst (torn write, zeroed block, bit flip).

_LEAF = "__leaf__"
_HEAD = struct.Struct("<I")
_FRAME = struct.Struct("<II")    # record length + crc32 of the head section
_ALIGN = 4096                    # records start on direct-IO block bounds


class _BlobDamage(Exception):
    """A record's head validated but a blob's fold did not (torn or
    corrupted item data). Internal to ``read_wal``'s torn-tail logic."""


class _NoGlobals(pickle.Unpickler):
    """Skeleton unpickler that resolves no class at all: a WAL skeleton is
    the bare placeholder string."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"WAL skeleton names {module}.{name}; a record holds one array "
            "or nothing")


# the only classes a reference snapshot's corpus skeleton may name, mapped
# by name to the port's formats (same fields: factors / cores and scale)
_SKELETON_CLASSES = {("repro.core.tensor_formats", "CPTensor"): CPTensor,
                     ("repro.core.tensor_formats", "TTTensor"): TTTensor}


class _SkeletonUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        cls = _SKELETON_CLASSES.get((module, name))
        if cls is None:
            raise RecoveryError(
                f"snapshot corpus skeleton names {module}.{name}; only "
                "repro.core.tensor_formats.CPTensor / TTTensor are read")
        return cls


def _aligned(n: int) -> int:
    return (int(n) + _ALIGN - 1) // _ALIGN * _ALIGN


def _fold64(arr: np.ndarray) -> int:
    b = arr.reshape(-1).view(np.uint8)
    n = b.nbytes - b.nbytes % 8
    acc = int(np.bitwise_xor.reduce(b[:n].view(np.uint64))) if n else 0
    if b.nbytes > n:
        acc ^= int.from_bytes(
            bytes(b[n:]) + b"\0" * (8 - b.nbytes + n), "little")
    return acc


def _tree_to_blobs(arr) -> tuple[dict, list[np.ndarray]]:
    if arr is None:
        return {"skeleton": None, "leaves": []}, []
    blobs = [np.ascontiguousarray(np.asarray(arr))]
    head = {"skeleton": base64.b64encode(pickle.dumps(_LEAF)).decode(),
            "leaves": [{"dtype": b.dtype.str, "shape": list(b.shape),
                        "len": int(b.nbytes), "fold": _fold64(b)}
                       for b in blobs]}
    return head, blobs


def _encode_record(lsn: int, kind: str, arr) -> tuple[bytes, list]:
    """-> (frame header + head section, raw blob arrays to follow it)."""
    head, blobs = _tree_to_blobs(arr)
    head.update(lsn=int(lsn), kind=kind)
    hb = json.dumps(head).encode()
    sect = _HEAD.pack(len(hb)) + hb
    length = len(sect) + sum(b.nbytes for b in blobs)
    return _FRAME.pack(length, zlib.crc32(sect)) + sect, blobs


def _decode_record(payload) -> tuple[int, str, Any]:
    """Decode one payload (head crc already verified by the caller);
    raises ``_BlobDamage`` on a blob fold mismatch."""
    (hlen,) = _HEAD.unpack_from(payload, 0)
    head = json.loads(bytes(payload[_HEAD.size:_HEAD.size + hlen]).decode())
    if head["skeleton"] is None:
        return int(head["lsn"]), head["kind"], None
    try:
        skeleton = _NoGlobals(io.BytesIO(
            base64.b64decode(head["skeleton"]))).load()
    except pickle.UnpicklingError as e:
        raise WalCorrupted(f"record {head['lsn']}: {e}") from e
    if skeleton != _LEAF or len(head["leaves"]) != 1:
        raise WalCorrupted(f"record {head['lsn']}: not one array")
    off = _HEAD.size + hlen
    spec = head["leaves"][0]
    # a bytearray copy realigns the slice for the uint64 fold view and
    # leaves the array writable for the replay's torch.from_numpy
    raw = np.frombuffer(bytearray(payload[off:off + spec["len"]]),
                        dtype=np.dtype(spec["dtype"]))
    arr = raw.reshape(spec["shape"])
    if _fold64(arr) != spec["fold"]:
        raise _BlobDamage(f"blob checksum mismatch at payload offset {off}")
    return int(head["lsn"]), head["kind"], arr


# ---------------------------------------------------------------------------
# Write-ahead log
# ---------------------------------------------------------------------------

_WAL_RE = re.compile(r"wal_(\d{12})\.log")
_SNAP_RE = re.compile(r"snap_(\d{12})")


def _wal_files(directory: str) -> list[tuple[int, str]]:
    """(start_lsn, path) of every WAL segment, in lsn order."""
    out = []
    for name in os.listdir(directory):
        m = _WAL_RE.fullmatch(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(out)


def _head_valid(data, off) -> bool:
    """Does a plausible record with a passing head crc start at off?"""
    if len(data) - off < _FRAME.size:
        return False
    length, crc = _FRAME.unpack_from(data, off)
    if length < _HEAD.size or off + _FRAME.size + length > len(data):
        return False
    (hlen,) = _HEAD.unpack_from(data, off + _FRAME.size)
    sect_end = off + _FRAME.size + _HEAD.size + hlen
    if _HEAD.size + hlen > length:
        return False
    return zlib.crc32(data[off + _FRAME.size:sect_end]) == crc


def _any_record_beyond(data, off) -> bool:
    """Scan aligned offsets strictly past ``off`` (the damaged record's
    start) for any valid-looking record: tells a torn tail (nothing but
    zeros or garbage follows) from mid-log corruption (intact records
    follow the damage)."""
    off = _aligned(off + 1)
    while off < len(data):
        if _head_valid(data, off):
            return True
        off += _ALIGN
    return False


def read_wal(directory: str):
    """Scan every WAL segment -> (records, tail).

    Records sit at ``_ALIGN``-ed offsets; a zero length field marks the
    end of a prezeroed segment. ``records`` is ``[(lsn, kind, array or
    None), ...]`` in commit order; ``tail`` is ``(path, valid_end)`` of the
    newest segment: the byte offset after its last whole record, where
    recovery resumes appending. A damaged final record of the newest
    segment (short frame, failed head checksum, failed blob fold) is a torn
    tail, a crash mid-append, and is dropped; the same damage with intact
    records after it, or in any older segment, raises ``WalCorrupted``, as
    does an lsn discontinuity between records.
    """
    files = _wal_files(directory)
    records: list[tuple[int, str, Any]] = []
    tail = None
    for idx, (start, path) in enumerate(files):
        last = idx == len(files) - 1
        with open(path, "rb") as f:
            data = f.read()
        view = memoryview(data)
        off = 0
        while len(data) - off >= _FRAME.size:
            length, crc = _FRAME.unpack_from(data, off)
            if length == 0:
                break                       # prezeroed tail: end of log
            end = off + _FRAME.size + length
            bad = None
            if length < _HEAD.size or end > len(data):
                bad = "truncated record"
            elif not _head_valid(data, off):
                bad = "checksum mismatch"
            else:
                try:
                    rec = _decode_record(view[off + _FRAME.size:end])
                except _BlobDamage as e:
                    bad = str(e)
            if bad is None:
                records.append(rec)
                off = _aligned(end)
                continue
            if last and not _any_record_beyond(data, off):
                break                       # torn tail: crash mid-append
            raise WalCorrupted(f"{path}: {bad} at offset {off}")
        if last:
            tail = (path, off)
    for (a, _, _), (b, _, _) in zip(records, records[1:]):
        if b != a + 1:
            raise WalCorrupted(f"lsn discontinuity: record {a} followed "
                               f"by {b}")
    return records, tail


_MIN_SEG = 256 * 1024            # first segment; sized up as records grow
_MAX_SEG = 64 * 1024 * 1024


class MutationLog:
    """One open WAL segment with an overlapped, near-zero-CPU commit.

    Segments are preallocated and prezeroed, records start on ``_ALIGN``
    boundaries, and appends go through ``O_DIRECT`` where the filesystem
    allows it (buffered + ``fdatasync`` otherwise):
    with the extents already materialized, the per-commit ``fdatasync`` is
    a device flush with no metadata journaling, which the committer thread
    hides under the caller's apply.

    ``begin`` fires ``pre_wal_append`` on the caller's thread (nothing is
    written if it faults) and hands the encode + write + sync of a host
    array to a single committer thread. ``finish`` joins the committer and
    fires ``post_wal_append``: when it returns, the record survives
    process death. ``cancel`` rolls a begun record back out of the log (the
    apply failed, so the record must not replay). ``append`` is the
    synchronous composition (epoch markers). On any failure mid-append the
    record's region is wound back to zeros, so a retry never leaves a torn
    record inside the log. ``rotate(lsn)`` starts a fresh segment (after a
    snapshot covering ``lsn``).
    """

    def __init__(self, directory: str, *, next_lsn: int,
                 path: str | None = None, append_at: int = 0,
                 injector: FaultInjector | None = None):
        self.directory = directory
        self.next_lsn = int(next_lsn)
        self.injector = injector or FaultInjector()
        self._committer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="wal-commit")
        self._buf: mmap.mmap | None = None
        self._fd = None
        self._max_record = 0
        self._open_segment(
            path or os.path.join(directory,
                                 f"wal_{self.next_lsn:012d}.log"),
            append_at=append_at)

    # -- segment management --------------------------------------------------

    def _open_segment(self, path: str, *, append_at: int = 0,
                      min_size: int = 0) -> None:
        """Open ``path`` for appending at ``append_at`` (aligned up):
        anything beyond (a torn tail, a stale prezeroed area) is cut and
        re-zeroed out to the segment's preallocated size."""
        if self._fd is not None:
            os.close(self._fd)
        self._path = path
        self._off = _aligned(append_at)
        size = max(_MIN_SEG, _aligned(min_size), self._off,
                   _aligned(os.path.getsize(path))
                   if os.path.exists(path) else 0)
        with open(path, "r+b" if os.path.exists(path) else "w+b") as f:
            f.truncate(self._off)
            f.seek(self._off)
            left = size - self._off
            chunk = b"\0" * min(1 << 22, max(left, 1))
            while left > 0:
                left -= f.write(chunk[:min(len(chunk), left)])
            f.flush()
            os.fsync(f.fileno())
        self._size = size
        try:
            self._fd = os.open(path, os.O_WRONLY | os.O_DIRECT)
            self._direct = True
        except OSError:                      # filesystem without direct IO
            self._fd = os.open(path, os.O_WRONLY)
            self._direct = False

    def _staging(self, n: int) -> mmap.mmap:
        """A reusable page-aligned buffer of >= n bytes (direct IO needs
        block-aligned memory; mmap pages are)."""
        if self._buf is None or len(self._buf) < n:
            if self._buf is not None:
                self._buf.close()
            self._buf = mmap.mmap(-1, max(_aligned(n), _MIN_SEG))
        return self._buf

    def _wind_back(self, start: int, need: int) -> None:
        """Return the region of a failed or cancelled append to zeros."""
        try:
            if self._direct:
                buf = self._staging(need)
                buf[:need] = b"\0" * need
                os.pwrite(self._fd, memoryview(buf)[:need], start)
                os.fdatasync(self._fd)
            else:
                os.truncate(self._path, start)
        except OSError:
            pass
        self._off = start

    def _append_sync(self, kind: str, arr) -> tuple[int, int, int]:
        """Committer-thread body: -> (lsn, record offset, aligned size)."""
        frame, blobs = _encode_record(self.next_lsn, kind, arr)
        need = _aligned(len(frame) + sum(b.nbytes for b in blobs))
        self._max_record = max(self._max_record, need)
        if self._off + need > self._size:
            self._open_segment(
                os.path.join(self.directory,
                             f"wal_{self.next_lsn:012d}.log"),
                min_size=max(32 * need, min(32 * self._max_record,
                                            _MAX_SEG)))
        start = self._off
        try:
            if self._direct:
                buf = self._staging(need)
                buf[:len(frame)] = frame
                pos = len(frame)
                for b in blobs:
                    if b.nbytes:
                        buf[pos:pos + b.nbytes] = b.reshape(-1).view(
                            np.uint8).data
                        pos += b.nbytes
                buf[pos:need] = b"\0" * (need - pos)
                os.pwrite(self._fd, memoryview(buf)[:need], start)
            else:
                os.lseek(self._fd, start, os.SEEK_SET)
                os.write(self._fd, frame)
                for b in blobs:
                    if b.nbytes:
                        os.write(self._fd, b.reshape(-1).view(np.uint8).data)
            os.fdatasync(self._fd)
        except BaseException:
            self._wind_back(start, need)
            raise
        self._off = start + need
        lsn = self.next_lsn
        self.next_lsn += 1
        return lsn, start, need

    # -- commit protocol -----------------------------------------------------

    def begin(self, kind: str, arr) -> Future:
        """Start committing one record (a host ndarray or None). Raises
        before touching the file on an armed ``pre_wal_append`` fault (the
        record is not committed); otherwise the write + sync proceed on
        the committer thread while the caller applies the mutation."""
        self.injector.fire("pre_wal_append")
        return self._committer.submit(self._append_sync, kind, arr)

    def finish(self, token: Future) -> int:
        """Join a ``begin``; -> the record's lsn, now durable. An armed
        ``post_wal_append`` fault fires with the record already synced."""
        lsn, _, _ = token.result()
        self.injector.fire("post_wal_append")
        return lsn

    def cancel(self, token: Future) -> None:
        """Roll a begun record back out (the apply failed): if the
        committer got it onto disk, zero it back off; a committer failure
        already wound itself back (and is swallowed: the caller is
        re-raising the apply's error)."""
        try:
            _, start, need = token.result()
        except BaseException:
            return
        self._wind_back(start, need)
        self.next_lsn -= 1

    def append(self, kind: str, arr) -> int:
        """Synchronous commit of one record; returns its lsn."""
        return self.finish(self.begin(kind, arr))

    def rotate(self, lsn: int) -> None:
        path = os.path.join(self.directory, f"wal_{int(lsn):012d}.log")
        if path == self._path and self._off == 0:
            return                           # already a fresh, empty segment
        self._open_segment(path,
                           min_size=min(32 * self._max_record, _MAX_SEG))

    def close(self) -> None:
        if self._fd is not None:
            self._committer.shutdown(wait=True)
            os.close(self._fd)
            self._fd = None
            if self._buf is not None:
                self._buf.close()
                self._buf = None


# ---------------------------------------------------------------------------
# Atomic snapshots
# ---------------------------------------------------------------------------


def _service_config(svc: LSHService) -> dict:
    """The identity a snapshot is only valid for: family + index layout,
    the reference's fields and values. Recovery compares this against the
    recovering service's own config and refuses on any mismatch: replay
    through a different family would silently build a different index."""
    fam, index = svc.index.family, svc.index
    return {
        "index": type(index).__name__,
        "metric": index.metric,
        "seed": int(index.seed),
        "kind": fam.kind,
        "num_codes": int(fam.num_codes),
        "num_tables": int(fam.num_tables),
        "bucket_width": float(fam.bucket_width),
        "shards": int(getattr(index, "shards", 0)),
        "bucket_cap": (None if index.bucket_cap is None
                       else int(index.bucket_cap)),
        "max_deltas": int(index.max_deltas),
    }


def latest_snapshot(directory: str) -> int | None:
    """lsn of the newest complete snapshot (manifest present), if any."""
    if not os.path.isdir(directory):
        return None
    lsns = []
    for name in os.listdir(directory):
        m = _SNAP_RE.fullmatch(name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            lsns.append(int(m.group(1)))
    return max(lsns) if lsns else None


def _host(t: torch.Tensor) -> np.ndarray:
    """A device array's host copy, on the current stream (``Tensor.cpu``
    waits for that stream only)."""
    return t.detach().cpu().numpy()


def _corpus_format(corpus) -> dict:
    if corpus.layout == "dense":
        return {"format": "dense"}
    return {"format": corpus.layout, "scale": float(corpus.scale)}


def write_snapshot(directory: str, lsn: int, svc: LSHService,
                   injector: FaultInjector | None = None) -> str:
    """Atomically dump the service's ``SegmentStore`` as of log position
    ``lsn`` (the number of WAL records the state includes): everything
    into ``snap_<lsn>.tmp/``, the crc32 manifest fsync'd, then one
    ``os.rename`` publishes it. A crash anywhere in between leaves only an
    ignored ``.tmp`` directory behind."""
    injector = injector or FaultInjector()
    store = svc.index.store
    state = store.host_state()
    name = f"snap_{int(lsn):012d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    counter = itertools.count()

    def put(arr) -> dict:
        arr = np.asarray(arr)
        fname = f"arr_{next(counter):05d}.npy"
        np.save(os.path.join(tmp, fname), arr, allow_pickle=False)
        return {"file": fname,
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes())}

    manifest: dict = {"lsn": int(lsn), "config": _service_config(svc),
                      "seq_len": state["seq_len"],
                      "live_window": state["live_window"], "segments": []}
    for seg, pos in zip([store.base] + store.deltas, state["slot_pos"]):
        entry = {"type": type(seg).__name__, "cap": int(seg.cap),
                 "keys": put(_host(seg.keys).astype(np.uint32)),
                 "sorted_keys": put(_host(seg.sorted_keys).astype(np.uint32)),
                 "perm": put(_host(seg.perm).astype(np.int32)),
                 "slot_pos": put(pos),
                 "corpus_format": _corpus_format(seg.corpus),
                 "corpus": [put(_host(leaf)) for leaf in seg.corpus.leaves]}
        if isinstance(seg, ShardedSegment):
            entry["counts"] = [int(c) for c in seg.counts]
        manifest["segments"].append(entry)
    injector.fire("mid_snapshot")
    manifest["live_host"] = put(state["live_host"])
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _corpus_spec(entry: dict) -> tuple[str, float]:
    """(format, scale) of a segment entry's corpus: the port's
    ``corpus_format``, or the reference's pickled skeleton (its bare
    placeholder a dense array, else a ``CPTensor`` / ``TTTensor``)."""
    if "corpus_format" in entry:
        spec = entry["corpus_format"]
        return spec["format"], float(spec.get("scale", 1.0))
    skeleton = _SkeletonUnpickler(io.BytesIO(
        base64.b64decode(entry["corpus_skeleton"]))).load()
    if skeleton == _LEAF:
        return "dense", 1.0
    if not isinstance(skeleton, (CPTensor, TTTensor)):
        raise RecoveryError(f"snapshot corpus skeleton is a "
                            f"{type(skeleton).__name__}")
    return skeleton.layout, float(skeleton.scale)


def load_snapshot(directory: str, lsn: int, config: dict, device):
    """-> (segments on ``device``, host_state) of snapshot ``lsn``,
    crc-verified, each segment rebuilt by ``convert.segment_from_numpy``:
    keys back to int64, perms int32, the corpus stacked by the builds' own
    ``stack`` (a sharded segment's slots flattened first), its leaves
    views of the stacked copy. Raises ``RecoveryError`` on a config
    mismatch, a corrupt array or a corpus skeleton naming another
    class."""
    path = os.path.join(directory, f"snap_{int(lsn):012d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    diffs = {k: (manifest["config"].get(k), v) for k, v in config.items()
             if manifest["config"].get(k) != v}
    if diffs:
        raise RecoveryError(
            f"snapshot {path} was written by a differently-configured "
            f"service; mismatched (snapshot, live) fields: {diffs}")

    def get(ref: dict) -> np.ndarray:
        arr = np.load(os.path.join(path, ref["file"]), allow_pickle=False)
        if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != ref["crc32"]:
            raise RecoveryError(
                f"snapshot corruption in {path}/{ref['file']}")
        return arr

    segs, slot_pos = [], []
    for entry in manifest["segments"]:
        layout, scale = _corpus_spec(entry)
        leaves = [get(r) for r in entry["corpus"]]
        segs.append(segment_from_numpy(
            leaves[0] if layout == "dense" else leaves,
            get(entry["sorted_keys"]), get(entry["perm"]),
            get(entry["keys"]), int(entry["cap"]), device=device,
            corpus_scale=scale, counts=entry.get("counts")))
        slot_pos.append(get(entry["slot_pos"]))
    state = {"slot_pos": slot_pos, "live_host": get(manifest["live_host"]),
             "seq_len": int(manifest["seq_len"]),
             "live_window": bool(manifest["live_window"])}
    return segs, state


def _prune(directory: str, cover: int, keep_snapshots: int) -> None:
    """Drop snapshots beyond the newest ``keep_snapshots`` and every WAL
    segment that ends at or before the oldest kept snapshot."""
    snaps = sorted(
        int(m.group(1)) for name in os.listdir(directory)
        if (m := _SNAP_RE.fullmatch(name))
        and os.path.exists(os.path.join(directory, name, "manifest.json")))
    for lsn in snaps[:-keep_snapshots] if keep_snapshots else snaps:
        shutil.rmtree(os.path.join(directory, f"snap_{lsn:012d}"),
                      ignore_errors=True)
    oldest_kept = snaps[-keep_snapshots] if snaps else cover
    files = _wal_files(directory)
    for (start, path), (next_start, _) in zip(files, files[1:]):
        if next_start <= oldest_kept:
            os.remove(path)


# ---------------------------------------------------------------------------
# Durable service
# ---------------------------------------------------------------------------


def _dense_items(batch) -> tuple[np.ndarray, torch.Tensor]:
    """A dense insert batch -> (its one host copy: the record and the
    replay's input; the tensor the apply reads: the caller's where one was
    given, else that copy). CP and TT batches are refused (ROADMAP.md,
    R6)."""
    if isinstance(batch, (CPTensor, TTTensor)):
        raise TypeError(
            f"a durable insert logs dense items only; got a batched "
            f"{type(batch).__name__} (the reference's WAL holds dense "
            "batches only, ROADMAP.md R6)")
    if isinstance(batch, DenseTensor):
        batch = batch.data
    if isinstance(batch, torch.Tensor):
        return np.ascontiguousarray(_host(batch)), batch
    items = np.ascontiguousarray(np.asarray(batch))
    return items, torch.from_numpy(items)


class DurableLSHService(LSHService):
    """``LSHService`` whose mutations are write-ahead committed.

    ``build()`` starts a fresh durable identity under ``directory``
    (snapshot at lsn 0 + a new WAL); every ``insert`` / ``delete`` and
    every published swap appends an fsync'd record, overlapped with the
    apply but joined before the call returns: committed iff appended.
    Every ``snapshot_every`` records a new snapshot is written and the WAL
    rotated. ``recover()``, on a freshly constructed, identically
    configured instance or in place on a degraded one, restores the latest
    complete snapshot and replays the log suffix, bit for bit.
    ``last_recovery`` holds the newest recovery's seconds in load (the
    snapshot read and upload), install (the store's lookups and view),
    replay and reopen (the WAL's tail cut and its segment re-zeroed out to
    its preallocated size), and the records replayed.
    """

    def __init__(self, family, directory: str, *, snapshot_every: int = 512,
                 keep_snapshots: int = 2,
                 injector: FaultInjector | None = None, **kwargs):
        super().__init__(family, **kwargs)
        if int(snapshot_every) < 1:
            raise ValueError(
                f"snapshot_every must be >= 1, got {snapshot_every}")
        self.directory = str(directory)
        self.snapshot_every = int(snapshot_every)
        self.keep_snapshots = int(keep_snapshots)
        self.injector = injector or FaultInjector()
        self.health = "cold"
        self._log: MutationLog | None = None
        self._cover = 0          # lsn the latest snapshot covers
        self.last_recovery: dict = {}

    @property
    def direct_io(self) -> bool | None:
        """Whether the open WAL segment takes ``O_DIRECT`` (None when no
        log is open)."""
        return None if self._log is None else self._log._direct

    # -- lifecycle ----------------------------------------------------------

    def build(self, corpus, batch_size: int = 65536) -> "DurableLSHService":
        """(Re)build from a corpus and start a fresh durable identity:
        prior snapshots and WAL under the directory belong to a corpus this
        instance no longer serves and are removed."""
        os.makedirs(self.directory, exist_ok=True)
        self._close_log()
        for name in os.listdir(self.directory):
            if _WAL_RE.fullmatch(name):
                os.remove(os.path.join(self.directory, name))
            elif _SNAP_RE.fullmatch(name) or _SNAP_RE.fullmatch(
                    name.removesuffix(".tmp")):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        super().build(corpus, batch_size=batch_size)
        self._write_snapshot(0)
        self._cover = 0
        self._log = MutationLog(self.directory, next_lsn=0,
                                injector=self.injector)
        self.health = "serving"
        return self

    def close(self) -> None:
        self._close_log()

    def _close_log(self) -> None:
        if self._log is not None:
            self._log.close()
            self._log = None

    def _require_serving(self, what: str) -> None:
        if self.health != "serving":
            self.stats.unavailable += 1
            raise ServiceUnavailable(
                f"{what} rejected: durable service is {self.health!r} "
                "(recover() restores it to 'serving')")

    # -- write-ahead commit --------------------------------------------------

    def _commit(self, kind: str, arr) -> int:
        t0 = time.perf_counter()
        lsn = self._log.append(kind, arr)
        self.stats.wal_ms += (time.perf_counter() - t0) * 1e3
        self.stats.wal_appends += 1
        return lsn

    def _commit_overlapped(self, kind: str, arr, apply_fn) -> None:
        """Commit a record while ``apply_fn`` runs: the fsync proceeds on
        the committer thread under the apply, and the caller returns only
        once both are done: the commit-then-apply contract of ``_commit``
        without paying the two latencies one after the other. An apply
        failure cancels the record (it must not replay); a commit failure
        after a successful apply leaves memory ahead of the log, so the
        service degrades rather than commit further ops on top of unlogged
        state."""
        t0 = time.perf_counter()
        token = self._log.begin(kind, arr)
        t_begin = time.perf_counter()
        try:
            apply_fn()
        except BaseException:
            self._log.cancel(token)
            raise
        t_apply = time.perf_counter()
        try:
            self._log.finish(token)
        except InjectedCrash:
            raise               # durable AND applied: consistent as it lies
        except BaseException:
            self.health = "degraded"
            raise
        self.stats.wal_ms += ((t_begin - t0)
                              + (time.perf_counter() - t_apply)) * 1e3
        self.stats.wal_appends += 1

    def _maybe_snapshot(self) -> None:
        if self._log.next_lsn - self._cover >= self.snapshot_every:
            self.snapshot()

    def snapshot(self) -> "DurableLSHService":
        """Write a snapshot now, rotate the WAL, prune old state."""
        self._require_serving("snapshot")
        lsn = self._log.next_lsn
        self._write_snapshot(lsn)
        self._cover = lsn
        self._log.rotate(lsn)
        _prune(self.directory, lsn, self.keep_snapshots)
        return self

    def _write_snapshot(self, lsn: int) -> None:
        t0 = time.perf_counter()
        write_snapshot(self.directory, lsn, self, self.injector)
        self.stats.snapshot_ms += (time.perf_counter() - t0) * 1e3
        self.stats.snapshots += 1

    # -- mutations (logged) --------------------------------------------------

    def query_arrays(self, queries, topk: int = 10, **kwargs):
        self._require_serving("query")
        return super().query_arrays(queries, topk, **kwargs)

    def insert(self, batch, batch_size: int = 2048) -> "DurableLSHService":
        """Log and apply a dense batch: one host copy (taken on the current
        stream) is the record, and the apply reads the same values (the
        caller's tensor where one was given, else that copy)."""
        self._require_serving("insert")
        items, apply = _dense_items(batch)
        self._commit_overlapped(
            "insert", items,
            lambda: LSHService.insert(self, apply, batch_size=batch_size))
        self._maybe_snapshot()
        return self

    def delete(self, ids) -> int:
        self._require_serving("delete")
        ids = _host(ids) if isinstance(ids, torch.Tensor) else np.asarray(ids)
        out = []
        self._commit_overlapped(
            "delete", ids,
            lambda: out.append(LSHService.delete(self, ids)))
        self._maybe_snapshot()
        return out[0]

    def apply_swap(self, pending) -> "DurableLSHService":
        """Publish a prepared swap with an epoch marker ahead of the flip.
        The marker commits only after the same staleness check the flip
        itself makes, so a record is never logged for a swap that then
        refuses to publish."""
        if pending is None:
            return self
        self._require_serving("apply_swap")
        store = self._mutable_index().store
        if (store is not pending.source
                or store.generation != pending.generation):
            return super().apply_swap(pending)   # the standard stale error
        self._commit(pending.kind, None)
        self.injector.fire("pre_apply_swap")
        super().apply_swap(pending)
        self._maybe_snapshot()
        return self

    # -- recovery ------------------------------------------------------------

    def recover(self) -> "DurableLSHService":
        """Restore the latest complete snapshot + replay the WAL suffix.

        Replays through the plain ``LSHService`` mutation path (no
        re-logging); the log's own torn tail, if any, is truncated before
        the WAL reopens for appends. The uploads and the store's view are
        made on the current stream (the scheduler's ingest stream when it
        runs the recovery), and the view's ``ready`` event orders a reader
        on another stream after them. On any failure the service lands in
        ``"degraded"`` and the error propagates: it never half-serves."""
        t0 = time.perf_counter()
        self.health = "recovering"
        self._close_log()
        try:
            lsn = latest_snapshot(self.directory)
            if lsn is None:
                raise RecoveryError(
                    f"no complete snapshot under {self.directory!r}; "
                    "nothing to recover from")
            segs, state = load_snapshot(self.directory, lsn,
                                        _service_config(self), self.device)
            t_load = time.perf_counter()
            self._install(segs, state)
            t_install = time.perf_counter()
            records, tail = read_wal(self.directory)
            expect = lsn
            for rec_lsn, kind, arr in records:
                if rec_lsn < lsn:
                    continue
                if rec_lsn != expect:
                    raise RecoveryError(
                        f"WAL gap: snapshot covers lsn {lsn}, expected "
                        f"record {expect} next but found {rec_lsn}")
                self._replay(kind, arr)
                expect += 1
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            t_replay = time.perf_counter()
            if tail is not None:
                path, valid_end = tail         # reopen past the last whole
                self._log = MutationLog(self.directory, next_lsn=expect,
                                        path=path, append_at=valid_end,
                                        injector=self.injector)
            else:
                self._log = MutationLog(self.directory, next_lsn=expect,
                                        injector=self.injector)
            self._cover = lsn
        except BaseException:
            self.health = "degraded"
            raise
        self.last_recovery = {"load_s": t_load - t0,
                              "install_s": t_install - t_load,
                              "replay_s": t_replay - t_install,
                              "reopen_s": time.perf_counter() - t_replay,
                              "records": expect - lsn}
        self.stats.recoveries += 1
        self.stats.recovery_ms += (time.perf_counter() - t0) * 1e3
        self.health = "serving"
        return self

    def _install(self, segs, state) -> None:
        index = self._mutable_index()
        index._reset_mutation_state()
        index.store = SegmentStore.restore(segs, state)
        if isinstance(index, ShardedLSHIndex):
            index._corpus = None
        self.stats.reset_mutations()
        self._track_shards()

    def _replay(self, kind: str, arr) -> None:
        # Explicitly the base-class methods: replay must apply, not re-log.
        if kind == "insert":
            LSHService.insert(self, torch.from_numpy(arr))
        elif kind == "delete":
            LSHService.delete(self, arr)
        elif kind == "compact":
            LSHService.apply_swap(self, LSHService.prepare_compact(self))
        elif kind == "rebalance":
            LSHService.apply_swap(self, LSHService.prepare_rebalance(self))
        else:
            raise RecoveryError(f"unknown WAL record kind {kind!r}")
