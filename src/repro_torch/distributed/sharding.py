"""Logical-axis rules over a mesh of devices (reference:
``repro.distributed.sharding``, its rule context).

A ``Mesh`` is an array of ``torch.device`` with one name per axis, the
counterpart of a JAX mesh in one process: each entry is a *slot*, and an
entry may name a device more than once (a 4-slot mesh on ``cuda:0`` lays
four shards on one card, as the reference's forced host devices do). A
rule set maps each logical dim name to mesh axes; ``axis_rules(mesh)``
activates one for the calling thread, dropping the axes a rule names but
the mesh lacks, so the same rules serve a 1-D ``shard`` mesh and a 2-D
``(data, model)`` one. The sharded index reads its ``lsh_shard`` rule
(``distributed.index_sharding.resolve_mesh``). The models annotate their
activations with ``shard(x, *names)``: ``resolve_spec`` resolves the names
under the active rules with the reference's divisibility fallback
(recorded in ``ctx.fallbacks``), and ``shard`` returns ``x`` itself, since
a tensor of one process lives on one card and the models are not split
over cards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Mapping, Sequence

import numpy as np
import torch

_STATE = threading.local()


# Default logical-name -> mesh-axes mapping for the production meshes
# ("pod", "data", "model"). Tuples mean the dim is sharded over several axes.
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": None,
    "kv_seq": None,
    "embed": None,
    "fsdp_embed": ("data", "pod"),
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "qkv_embed": None,
    "vocab": "model",
    "expert": "model",
    "capacity": ("pod", "data"),
    "dispatch": ("pod", "data"),
    "moe_d": "model",
    "chunks": "model",
    "conv": None,
    "state": None,
    "ssm_heads": "model",
    "ssm_inner": "model",
    "frames": None,
    "layers": None,
    "lsh_hash": None,
    "lsh_rank": None,
    # corpus-shard axis of the sharded LSH index: the dedicated 1-D "shard"
    # mesh, or the data axis on the production meshes (one of the two
    # survives the missing-axis cleaning in axis_rules)
    "lsh_shard": ("shard", "data"),
}


class Mesh:
    """An n-D array of ``torch.device`` slots with one name per axis.
    ``shape`` maps each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = list(np.asarray(devices, dtype=object).reshape(-1))
        shape = np.shape(np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{len(shape)} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis name in {self.axis_names}")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = [torch.device(d) for d in flat]
        self.devices = arr.reshape(shape)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


@dataclasses.dataclass
class RuleContext:
    mesh: Mesh
    rules: dict[str, tuple[str, ...] | str | None]
    fallbacks: list[tuple[str, int, tuple[str, ...]]] = dataclasses.field(
        default_factory=list)

    def axis_size(self, axes: tuple[str, ...]) -> int:
        return int(np.prod([self.mesh.shape[a] for a in axes]))


def current() -> RuleContext | None:
    """The calling thread's active rule context, or None."""
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def axis_rules(mesh: Mesh, overrides: Mapping[str, object] | None = None):
    """Activate sharding rules for the calling thread. Missing mesh axes in
    a rule are dropped (so the same rules work for (data, model) and
    (pod, data, model))."""
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    cleaned = {}
    for name, axes in rules.items():
        if axes is None:
            cleaned[name] = None
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        axes_t = tuple(a for a in axes_t if a in mesh.shape)
        cleaned[name] = axes_t or None
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = RuleContext(mesh=mesh, rules=cleaned)
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def resolve_spec(names: Sequence[str | None], shape: Sequence[int]
                 ) -> tuple:
    """Logical names -> one entry per dim (None, a mesh axis name, or a
    tuple of them) under the active context, the counterpart of the
    reference's PartitionSpec. A dim whose size the mapped axes do not
    divide is replicated and recorded in ``ctx.fallbacks``; a mesh axis
    appears once per spec. Returns () outside a context."""
    ctx = current()
    if ctx is None:
        return ()
    entries = []
    used: set[str] = set()
    for name, size in zip(names, shape):
        axes = ctx.rules.get(name) if name else None
        if not axes:
            entries.append(None)
            continue
        if any(a in used for a in axes):
            entries.append(None)
            continue
        if size % ctx.axis_size(axes) != 0:
            ctx.fallbacks.append((str(name), int(size), axes))
            entries.append(None)
            continue
        used.update(axes)
        entries.append(axes if len(axes) > 1 else axes[0])
    return tuple(entries)


def shard(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """The models' activation constraint by logical dim names: resolves
    them under the active context (recording fallbacks) and returns ``x``
    unchanged."""
    if current() is not None:
        resolve_spec(names, x.shape)
    return x
