"""AdamW with global-norm clipping and a warmup-cosine schedule (reference:
``repro.training.optimizer``), as plain functions on trees of tensors.

The numerics are the reference's: the schedule and the bias corrections
are float32 tensors, the update runs in float32 and casts back to the
parameter's dtype (round to nearest even), moments are kept in
``moment_dtype``, and weight decay applies to every leaf (norms and
phi3-lsh's ``lsh_proj`` too). The update writes the parameters and
moments in place (the reference's launcher donates the state) a chunk of
leading rows at a time: elementwise, so the bits do not change, and
phi3-mini's float32 temporaries stay near a few hundred MB instead of
~16 GB for its (32, 3072, 8192) MLP leaves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_map

# elements of a leaf updated at a time (rows of its leading dim), and
# summed at a time into the global norm (fixed: the norm's bits follow it)
UPDATE_CHUNK = 1 << 25
NORM_CHUNK = 1 << 25


class OptState(NamedTuple):
    step: torch.Tensor  # scalar int32
    mu: Any             # first moment, like params, in moment_dtype
    nu: Any             # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # bf16 halves optimizer memory at 400B


def schedule(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in float32."""
    step = step.to(torch.float32)
    warm = step / max(c.warmup_steps, 1)
    progress = torch.clamp((step - c.warmup_steps)
                           / max(c.decay_steps - c.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    decay = c.min_lr_ratio + (1 - c.min_lr_ratio) * cos
    return c.peak_lr * torch.where(step < c.warmup_steps, warm, decay)


def init(params, moment_dtype="float32") -> OptState:
    """Zero moments like ``params`` and step 0 on the params' device."""
    mdt = getattr(torch, moment_dtype) if isinstance(moment_dtype, str) \
        else moment_dtype
    leaves = tree_leaves(params)
    dev = leaves[0][1].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _chunks(t: torch.Tensor, limit: int) -> list:
    """Views of ``t`` along its leading dim, at most ``limit`` elements
    each where a row fits (the whole tensor if it has no leading dim)."""
    if t.ndim == 0 or t.numel() <= limit:
        return [t]
    rows = max(1, limit // max(1, t[0].numel()))
    return list(t.split(rows, dim=0))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed over the
    leaves in the reference's flatten order (sorted dict keys)."""
    total = 0
    for _, g in tree_leaves(tree):
        leaf = 0
        for part in _chunks(g, NORM_CHUNK):
            leaf = leaf + torch.sum(torch.square(part.to(torch.float32)))
        total = total + leaf
    return torch.sqrt(total)


def update(c: AdamWConfig, grads, state: OptState, params):
    """-> (params, new_state, metrics {"grad_norm", "lr"}). ``params`` and
    the moments of ``state`` are updated in place and returned."""
    gnorm = global_norm(grads)
    scale = torch.clamp(c.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(c, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(c.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(c.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    mdt = getattr(torch, c.moment_dtype)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = c.b1 * m.to(torch.float32) + (1 - c.b1) * g
        v32 = c.b2 * v.to(torch.float32) + (1 - c.b2) * g * g
        mh = m32 / b1c
        vh = v32 / b2c
        delta = mh / (torch.sqrt(vh) + c.eps) \
            + c.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        m.copy_(m32.to(mdt))
        v.copy_(v32.to(mdt))

    flat = zip(tree_leaves(params), tree_leaves(grads),
               tree_leaves(state.mu), tree_leaves(state.nu))
    with torch.no_grad():
        for (path, p), (_, g), (_, m), (_, v) in flat:
            if m.dtype != mdt:
                raise TypeError(f"moment of {path} is {m.dtype}, the "
                                f"config's moment_dtype {c.moment_dtype}")
            for parts in zip(*(_chunks(t, UPDATE_CHUNK)
                               for t in (p, g, m, v))):
                upd(*parts)
    return (params, OptState(step=step, mu=state.mu, nu=state.nu),
            {"grad_norm": gnorm, "lr": lr})
