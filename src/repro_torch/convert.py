"""Carry parameters from the reference package into port objects.

Every function takes numpy arrays (the caller does the ``np.asarray`` on the
reference's JAX arrays; this package never imports JAX) and returns port
objects on ``device``. ``model_params_from_numpy`` carries an LM's
parameter tree leaf for leaf. The reference samples with ``jax.random`` and the
port with ``torch.Generator``; the two never give the same numbers, so
parity is held on carried-over parameters, not on seeds. A dense corpus
crosses as one (n, d_1, ..., d_N) array, a naive family as its
(L*K, prod d) matrix (the reference's ``projection.matrix``). A training
state crosses leaf for leaf (``train_state_from_numpy`` /
``train_state_to_numpy``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.lsh import ALL_KINDS, E2LSH_KINDS, LSHFamily
from repro_torch.core.projections import (CPProjection, DenseProjection,
                                          TTProjection)
from repro_torch.core.segments import (SegmentStore, ShardedSegment,
                                       TableSegment)
from repro_torch.core.tensor_formats import CPTensor, DenseTensor, TTTensor
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import unstack_like
from repro_torch.models.params import param_specs, torch_dtype, tree_leaves


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


def tt_tensor_from_numpy(cores: Sequence[np.ndarray], scale: float,
                         device="cuda") -> TTTensor:
    """TT cores ((r, d_n, r') or batched (B, r, d_n, r') per mode) ->
    TTTensor."""
    dev = resolve_device(device)
    return TTTensor(tuple(_f32(c, dev) for c in cores), float(scale))


def dense_tensor_from_numpy(a: np.ndarray, n_modes: int | None = None,
                            device="cuda") -> DenseTensor:
    """A dense (n, d_1, ..., d_N) array (its last ``n_modes`` axes the
    modes, by default all but the first) -> DenseTensor."""
    a = np.asarray(a)
    n = a.ndim - 1 if n_modes is None else int(n_modes)
    return DenseTensor(_f32(a, resolve_device(device)),
                       tuple(a.shape[a.ndim - n:]))


def family_from_numpy(kind: str, factors: Sequence[np.ndarray], scale: float,
                      offsets: np.ndarray | None, num_codes: int,
                      num_tables: int, bucket_width: float,
                      device="cuda", dims: Sequence[int] | None = None
                      ) -> LSHFamily:
    """A reference family's projection leaves, scale and offsets ->
    ``LSHFamily``: CP factors (L*K, d_n, R) per mode for the cp-* kinds,
    TT cores (L*K, r, d_n, r') per mode for the tt-* kinds, and for the
    naive kinds 'e2lsh' / 'srp' the one (L*K, prod d) matrix, whose mode
    ``dims`` must be given."""
    if kind not in ALL_KINDS:
        raise ValueError(f"kind must be one of {ALL_KINDS}, got {kind!r}")
    dev = resolve_device(device)
    leaves = tuple(_f32(f, dev) for f in factors)
    if kind.startswith("cp-"):
        proj = CPProjection(leaves, float(scale))
    elif kind.startswith("tt-"):
        proj = TTProjection(leaves, float(scale))
    else:
        if dims is None:
            raise ValueError(f"a {kind!r} family needs its mode dims")
        (matrix,) = leaves
        proj = DenseProjection(matrix, tuple(dims), float(scale))
    offs = _f32(offsets, dev) if kind in E2LSH_KINDS else None
    return LSHFamily(projection=proj, offsets=offs, kind=kind,
                     num_codes=int(num_codes), num_tables=int(num_tables),
                     bucket_width=float(bucket_width))


def _stacked_corpus(leaves, scale: float, dev, lead: int):
    """Per-mode CP factors or TT cores, or one dense array, with ``lead``
    leading item dims -> (corpus, stacked) keeping those dims; leaves with
    4 dims past them are TT cores."""
    if isinstance(leaves, np.ndarray):
        shape = leaves.shape[:lead]
        corpus, stacked = dense_tensor_from_numpy(
            leaves.reshape((-1,) + leaves.shape[lead:]), device=dev).stack()
        stacked = stacked.unflatten(0, shape)
        return unstack_like(corpus, stacked), stacked
    shape = np.shape(leaves[0])[:lead]
    flat = [np.reshape(a, (-1,) + np.shape(a)[lead:]) for a in leaves]
    make = (tt_tensor_from_numpy if np.ndim(flat[0]) == 4
            else cp_tensor_from_numpy)
    corpus, stacked = make(flat, scale, dev).stack()
    stacked = stacked.unflatten(0, shape)
    return unstack_like(corpus, stacked), stacked


def segment_from_numpy(corpus_factors: Sequence[np.ndarray],
                       sorted_keys: np.ndarray, perm: np.ndarray,
                       keys: np.ndarray, cap: int, device="cuda",
                       corpus_scale: float = 1.0,
                       counts: Sequence[int] | None = None
                       ) -> TableSegment | ShardedSegment:
    """A reference ``TableSegment``'s arrays (corpus CP factors (m, d_n, R)
    or TT cores (m, r, d_n, r') per mode, or a dense (m, d_1, ..., d_N)
    numpy array, sorted_keys (L, m) uint32, perm (L, m) int32, keys (m, L)
    uint32) -> port ``TableSegment``; 4-D leaves are TT cores. With ``counts`` (real items per shard), a reference
    ``ShardedSegment``'s arrays (a leading shard dim S on every one: keys
    (S, n_s, L), sorted_keys / perm (S, L, n_s), corpus leaves
    (S, n_s, ...)) -> port ``ShardedSegment``."""
    dev = resolve_device(device)
    lead = 1 if counts is None else 2
    corpus, stacked = _stacked_corpus(corpus_factors, corpus_scale, dev,
                                      lead)
    arrays = dict(keys=_u32(keys, dev), sorted_keys=_u32(sorted_keys, dev),
                  perm=torch.from_numpy(np.array(perm, np.int32)).to(dev),
                  corpus=corpus, cap=int(cap), stacked=stacked)
    if counts is None:
        return TableSegment(**arrays)
    return ShardedSegment(counts=tuple(int(c) for c in counts), **arrays)


def store_from_numpy(segments: Sequence[dict], state: dict,
                     device="cuda") -> SegmentStore:
    """A reference ``SegmentStore`` carried across: one dict of
    ``segment_from_numpy``'s arguments per segment (base first, then the
    deltas in insert order; ``counts`` for the sharded base and slabs),
    all numpy, and the reference's ``host_state()`` (whose ``slot_pos``
    carries a shard-locally compacted base's ``base_pos``) -> a port store,
    through ``SegmentStore.restore``, so its lookups and effective ids are
    derived as every mutation derives them."""
    segs = [segment_from_numpy(device=device, **seg) for seg in segments]
    return SegmentStore.restore(segs, state)


def model_params_from_numpy(cfg, tree: dict, device="cuda") -> dict:
    """A reference LM parameter tree (nested dicts of numpy arrays, any
    float dtype, bfloat16 included) -> the port's tree on ``device`` in
    ``cfg``'s dtype, leaf for leaf. Raises unless the tree's paths and
    shapes are ``param_specs(cfg)``'s."""
    return _leaves_from_numpy(cfg, tree, torch_dtype(cfg),
                              resolve_device(device), "params")


def _field(obj, name: str):
    """A field of a reference NamedTuple or of a dict of the same names."""
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _leaves_from_numpy(cfg, tree: dict, dtype, dev, what: str) -> dict:
    """A tree with ``param_specs(cfg)``'s paths and shapes (checked) ->
    tensors of ``dtype`` on ``dev``."""
    want = {p: s.shape for p, s in tree_leaves(param_specs(cfg))}
    got = {p: tuple(np.shape(a)) for p, a in tree_leaves(tree)}
    if got != want:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        shapes = sorted(p for p in set(got) & set(want) if got[p] != want[p])
        raise ValueError(f"{what} tree does not match {cfg.name}'s specs: "
                         f"missing {missing}, extra {extra}, "
                         f"shape differs at {shapes}")

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else torch.from_numpy(
            np.array(v, dtype=np.float32)).to(dev, dtype)
            for k, v in t.items()}
    return walk(tree)


def train_state_from_numpy(cfg, tc, tree, device="cuda"):
    """A reference ``TrainState`` with numpy leaves (its NamedTuples, or
    dicts of the same field names: params, opt {step, mu, nu}, compressor
    {error} | None) -> the port's ``TrainState`` on ``device``: params in
    ``cfg``'s dtype, moments in ``tc.adamw.moment_dtype``, step int32, the
    compressor's error float32, leaf for leaf. Raises unless every tree's
    paths and shapes are ``param_specs(cfg)``'s."""
    from repro_torch.training import compression as C
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_loop as TL
    dev = resolve_device(device)
    opt = _field(tree, "opt")
    mdt = getattr(torch, tc.adamw.moment_dtype)
    params = _leaves_from_numpy(cfg, _field(tree, "params"), torch_dtype(cfg),
                                dev, "params")
    step = torch.tensor(int(np.asarray(_field(opt, "step"))),
                        dtype=torch.int32, device=dev)
    state = O.OptState(
        step=step,
        mu=_leaves_from_numpy(cfg, _field(opt, "mu"), mdt, dev, "mu"),
        nu=_leaves_from_numpy(cfg, _field(opt, "nu"), mdt, dev, "nu"))
    comp = _field(tree, "compressor")
    cstate = None if comp is None else C.CompressorState(
        error=_leaves_from_numpy(cfg, _field(comp, "error"), torch.float32,
                                 dev, "error"))
    return TL.TrainState(params=params, opt=state, compressor=cstate)


def train_state_to_numpy(state) -> dict:
    """The port's ``TrainState`` -> {"params", "opt": {"step", "mu", "nu"},
    "compressor": {"error"} | None} of numpy arrays (bfloat16 leaves as
    float32, exactly; copies, never views of the state's tensors), the
    inverse of ``train_state_from_numpy``."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        t = t.detach().cpu()
        # a copy: the train step updates a CPU state's tensors in place
        return np.array((t.float() if t.dtype == torch.bfloat16
                         else t).numpy())
    opt = state.opt
    return {"params": walk(state.params),
            "opt": {"step": walk(opt.step), "mu": walk(opt.mu),
                    "nu": walk(opt.nu)},
            "compressor": None if state.compressor is None
            else {"error": walk(state.compressor.error)}}
