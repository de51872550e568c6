"""Build and load the port's CUDA kernels (``kernels/csrc/*.cu``).

The sources are compiled on first use, one ``nvcc -c`` per source started
together, for ``sm_90a`` (Hopper), and linked into one shared library with a
plain C interface that ``ctypes`` loads. The library goes into
``kernels/_build/<hash of the sources>/`` (listed in ``.gitignore``), so a
changed source builds anew and an unchanged one is reused. Every C entry
point returns ``cudaGetLastError()``; ``check`` raises if it is not 0.

Nothing here runs at import: the CPU tests import every module of the port,
and a machine without ``nvcc`` builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_D = ctypes.c_double
# C signatures of the entry points (restype int = cudaError_t).
SIGNATURES = {
    # x, p, offsets, mults, out, B, N, D, RX, L, K, RP, epilogue, w, scale,
    # the plan's block items, block hashes, threads, shared bytes (checked),
    # stream
    "cp_gram_launch": [_P] * 5 + [_I] * 8 + [_F, _F, _I, _I, _I,
                                             ctypes.c_size_t, _P],
    # the same arguments, in the TT layouts
    "tt_inner_launch": [_P] * 5 + [_I] * 8 + [_F, _F, _I, _I, _I,
                                              ctypes.c_size_t, _P],
    # N, D, RX, RP, block items, block hashes, out (registers, blocks per
    # SM, local bytes)
    "cp_gram_occupancy": [_I] * 6 + [_P],
    # D, RX, RP, block items, block hashes, out
    "tt_inner_occupancy": [_I] * 5 + [_P],
    # values, offsets, mults, pairs, q, segment table, S, ids, scores,
    # ncand, B, L, K, T, C, N, D, RQ, RC, topk, e2, euclid, fmt, qfmt, w,
    # qs, window, scratch, scratch window, scratch query counter, the
    # densified queries' scratch, dims, DF, the query mode (0 topk, 1
    # uniform, 2 weighted) and the draw's two key words, the planned
    # threads, blocks per SM and shared bytes (checked), stream
    "fused_query_launch": [_P] * 6 + [_I] + [_P] * 3 + [_I] * 14
                          + [_F, _D, _I, _P, _I, _P, _P, _P, _I, _I, _U, _U,
                             _I, _I, ctypes.c_size_t, _P],
    # fmt, qfmt, RQ, RC, N, D, sample (the sampling instantiation), shared
    # bytes, out (registers, blocks per SM, local bytes, target blocks per
    # SM)
    "fused_query_occupancy": [_I, _I, _I, _I, _I, _I, _I, ctypes.c_size_t,
                              _P],
    # values, out, B, K, the plan's threads, blocks, rows a chunk, pieces a
    # row and path (1 vector, 0 scalar; checked), stream
    "srp_pack_launch": [_P, _P, ctypes.c_longlong] + [_I] * 6 + [_P],
    # path (1 vector, 0 scalar), out (registers, blocks per SM, local bytes)
    "srp_pack_occupancy": [_I, _P],
    # values, offsets, out, B, K, w, stream
    "e2lsh_quant_launch": [_P, _P, _P, ctypes.c_longlong, _I, _F, _P],
}

_LIB = None
_LIB_LOCK = threading.Lock()   # the serving scheduler's two lanes can make
                               # the first call at once
BUILD_INFO: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda"
                       "/bin): the port's CUDA kernels build on the card's "
                       "machine only")


def build() -> Path:
    """Compile the sources (if this digest is not built yet) -> library."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libreprotorch.so"
    if lib.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", (out_dir / "build.log").read_text()
                              if (out_dir / "build.log").exists() else "")
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    procs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp_lib = tmp / lib.name
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                           *objs], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    (out_dir / "build.log").write_text("\n".join(log))
    os.replace(tmp_lib, lib)
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = "\n".join(log)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, by one thread:
    the others wait for it)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.repro_cuda_error_string.argtypes = [_I]
            handle.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        what = lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({what}) at launch")
