"""Atomic, async checkpointing with integrity checks (reference:
``repro.training.checkpoint``), in the reference's layout byte for byte.

Layout (one directory per step):
    <dir>/step_00000100.tmp/...   -> atomically renamed to step_00000100/
        manifest.json   {step, leaves {key: file, shape, dtype, crc32}, meta}
        leaf_00000.npy  one file per tree leaf, numbered in sorted key order

Keys are the reference's ``tree_flatten_with_path`` paths after its
``re.sub(r"[^\\w.]", "", ...)``: a NamedTuple field is ``.name``, a dict
key its name, joined by "/" (``.params/blocks/wq``, ``.opt/.step``,
``.compressor/.error/embed/tokens``); a None field has no leaves.

* atomic: writes go to a .tmp dir, the manifest fsync'd, then os.rename —
  a crash mid-save never corrupts the latest complete checkpoint.
* async: save() can run on a background thread; the leaves are copied to
  host memory before the thread starts, so the caller may go on updating
  the state in place.
* integrity: crc32 per leaf, verified on restore; a mismatch or a missing
  leaf raises IOError.
* bfloat16: numpy has no bfloat16 here. A bfloat16 leaf is written as the
  reference writes it (``np.save`` of an ``ml_dtypes`` array): its 2-byte
  patterns under the header descr ``'<V2'``, manifest dtype "bfloat16";
  restore reads the patterns back by the manifest's dtype (uint16 views),
  so the port resumes its own full-config checkpoints and reads the
  reference's. The reference cannot restore such a leaf (caveat R10: its
  ``jnp.asarray`` of the void array raises TypeError).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

_SEP = "/"
_BF16_DESCR = "<V2"


def _walk(tree, path: tuple, out: list) -> None:
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            _walk(getattr(tree, name), path + ("." + name,), out)
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], path + (re.sub(r"[^\w.]", "", str(k)),), out)
        return
    out.append((_SEP.join(path), tree))


def _flatten(tree) -> dict[str, Any]:
    """{key: leaf} in the reference's flatten order."""
    out: list = []
    _walk(tree, (), out)
    return dict(out)


def _to_host(t) -> tuple[np.ndarray, str]:
    """(numpy array of the leaf's bytes, dtype name for the manifest)."""
    if isinstance(t, torch.Tensor):
        # a copy, also of a CPU tensor: the caller updates it in place
        t = t.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(t)
    return arr, str(arr.dtype)


def _write_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(np.ascontiguousarray(arr).tobytes())


def save(directory: str, step: int, tree, meta: dict | None = None,
         async_: bool = False) -> threading.Thread | None:
    os.makedirs(directory, exist_ok=True)
    flat = {k: _to_host(v) for k, v in _flatten(tree).items()}

    def write():
        name = f"step_{step:08d}"
        tmp = os.path.join(directory, name + ".tmp")
        final = os.path.join(directory, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}, "meta": meta or {}}
        for i, (key, (arr, dtype)) in enumerate(sorted(flat.items())):
            fname = f"leaf_{i:05d}.npy"
            _write_npy(os.path.join(tmp, fname), arr, dtype)
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": dtype,
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _from_host(arr: np.ndarray, dtype: str, dev) -> torch.Tensor:
    arr = np.array(arr, order="C")   # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def _rebuild(like, flat: dict, path: tuple, dev):
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, n), flat,
                                     path + ("." + n,), dev)
                            for n in like._fields))
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, path + (re.sub(r"[^\w.]", "", str(k)),),
                            dev)
                for k, v in like.items()}
    d = dev if dev is not None else (
        like.device if isinstance(like, torch.Tensor)
        and like.device.type != "meta" else torch.device("cpu"))
    return _from_host(*flat[_SEP.join(path)], d)


def restore(directory: str, step: int, like, device=None
            ) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (tensors, meta tensors
    included). Verifies CRCs. Leaves go to ``device`` if given, else to
    each ``like`` leaf's device (the CPU for a meta leaf)."""
    dev = resolve_device(device) if device is not None else None
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    restored = {}
    for key, info in manifest["leaves"].items():
        arr = np.load(os.path.join(path, info["file"]))
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        if crc != info["crc32"]:
            raise IOError(f"checkpoint corruption in leaf {key!r}")
        restored[key] = (arr, info["dtype"])
    missing = set(_flatten(like)) - set(restored)
    if missing:
        raise IOError(f"checkpoint missing leaves: {sorted(missing)[:5]}...")
    return _rebuild(like, restored, (), dev), manifest["meta"]


def restore_latest(directory: str, like, device=None):
    step = latest_step(directory)
    if step is None:
        return None, None, None
    tree, meta = restore(directory, step, like, device=device)
    return tree, step, meta
