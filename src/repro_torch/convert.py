"""Carry parameters from the reference package into port objects.

Every function takes numpy arrays (the caller does the ``np.asarray`` on the
reference's JAX arrays; this package never imports JAX) and returns port
objects on ``device``. The reference samples with ``jax.random`` and the
port with ``torch.Generator``; the two never give the same numbers, so
parity is held on carried-over parameters, not on seeds.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.lsh import ALL_KINDS, E2LSH_KINDS, LSHFamily
from repro_torch.core.projections import CPProjection
from repro_torch.core.segments import TableSegment
from repro_torch.core.tensor_formats import CPTensor
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import stack_cp


def _f32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def _u32(a, dev) -> torch.Tensor:
    """uint32 array -> int64 tensor holding the same unsigned values."""
    return torch.from_numpy(np.asarray(a).astype(np.uint32)
                            .astype(np.int64)).to(dev)


def cp_tensor_from_numpy(factors: Sequence[np.ndarray], scale: float,
                         device="cuda") -> CPTensor:
    """CP factors ((d_n, R) or batched (B, d_n, R) per mode) -> CPTensor."""
    dev = resolve_device(device)
    return CPTensor(tuple(_f32(f, dev) for f in factors), float(scale))


def family_from_numpy(kind: str, factors: Sequence[np.ndarray], scale: float,
                      offsets: np.ndarray | None, num_codes: int,
                      num_tables: int, bucket_width: float,
                      device="cuda") -> LSHFamily:
    """A reference CP family's projection factors ((L*K, d_n, R) per mode),
    scale and offsets -> ``LSHFamily``."""
    if kind not in ALL_KINDS:
        raise NotImplementedError(
            f"kind {kind!r}: the port carries the CP kinds {ALL_KINDS}")
    dev = resolve_device(device)
    proj = CPProjection(tuple(_f32(f, dev) for f in factors), float(scale))
    offs = _f32(offsets, dev) if kind in E2LSH_KINDS else None
    return LSHFamily(projection=proj, offsets=offs, kind=kind,
                     num_codes=int(num_codes), num_tables=int(num_tables),
                     bucket_width=float(bucket_width))


def segment_from_numpy(corpus_factors: Sequence[np.ndarray],
                       sorted_keys: np.ndarray, perm: np.ndarray,
                       keys: np.ndarray, cap: int, device="cuda",
                       corpus_scale: float = 1.0) -> TableSegment:
    """A reference ``TableSegment``'s arrays (corpus factors (m, d_n, R) per
    mode, sorted_keys (L, m) uint32, perm (L, m) int32, keys (m, L) uint32)
    -> port ``TableSegment``."""
    dev = resolve_device(device)
    corpus, stacked = stack_cp(
        cp_tensor_from_numpy(corpus_factors, corpus_scale, dev))
    return TableSegment(
        keys=_u32(keys, dev), sorted_keys=_u32(sorted_keys, dev),
        perm=torch.from_numpy(np.array(perm, np.int32)).to(dev),
        corpus=corpus, cap=int(cap), stacked=stacked)
