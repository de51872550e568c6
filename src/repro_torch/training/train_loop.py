"""Train step factory: loss and gradients by autograd, microbatch
accumulation, optional tensorized-sketch gradient compression, AdamW
(reference: ``repro.training.train_loop``).

The step takes the gradients of ``loss_fn`` with ``torch.autograd.grad``
over the parameter leaves in the reference's flatten order, accumulates
``grad_accum`` microbatches (split along the batch axis) in float32 from
zero-initialised sums as the reference's scan does, then compresses (if
configured) and updates. It updates the state's tensors in place and
returns the state (the reference's launcher donates it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import params as params_lib
from repro_torch.models import transformer as T
from repro_torch.training import compression as comp_lib
from repro_torch.training import optimizer as opt_lib


class TrainState(NamedTuple):
    params: Any
    opt: opt_lib.OptState
    compressor: comp_lib.CompressorState | None = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt_lib.AdamWConfig = dataclasses.field(
        default_factory=opt_lib.AdamWConfig)
    grad_accum: int = 1
    compression: comp_lib.CompressionConfig | None = None


def init_state(cfg: ModelConfig, tc: TrainConfig, gen: torch.Generator,
               device="cuda") -> tuple[TrainState, Any]:
    """(state, sketch seed | None): parameters drawn from ``gen`` (a
    generator on ``device``), zero moments, zero compressor error."""
    dev = resolve_device(device)
    params = params_lib.init_params(cfg, gen, device=dev)
    opt = opt_lib.init(params, tc.adamw.moment_dtype)
    sketch, cstate = (None, None)
    if tc.compression is not None:
        sketch, cstate = comp_lib.init_compressor(tc.compression, params)
    return TrainState(params=params, opt=opt, compressor=cstate), sketch


def abstract_state(cfg: ModelConfig, tc: TrainConfig) -> TrainState:
    """Meta-device tensors of the state's shapes and dtypes (dry-run)."""
    p = params_lib.abstract_params(cfg)
    mdt = getattr(torch, tc.adamw.moment_dtype)

    def mom(t):
        return torch.empty(t.shape, dtype=mdt, device="meta")
    return TrainState(
        params=p,
        opt=opt_lib.OptState(
            step=torch.empty((), dtype=torch.int32, device="meta"),
            mu=params_lib.tree_map(mom, p), nu=params_lib.tree_map(mom, p)),
        compressor=None)


def state_axes(cfg: ModelConfig) -> TrainState:
    """Logical-axis tree matching abstract_state (moments like params)."""
    axes = params_lib.param_axes(cfg)
    return TrainState(params=axes,
                      opt=opt_lib.OptState(step=(), mu=axes, nu=axes),
                      compressor=None)


def dryrun_train_config(cfg: ModelConfig) -> TrainConfig:
    """Production train hyper-structure per arch scale: > 50B params train
    with 4-way gradient accumulation (8-way past 100B), > 300B also with
    bf16 Adam moments."""
    n = params_lib.count_params(cfg)
    accum = 8 if n > 100e9 else (4 if n > 50e9 else 1)
    mdt = "bfloat16" if n > 300e9 else "float32"
    return TrainConfig(adamw=opt_lib.AdamWConfig(moment_dtype=mdt),
                       grad_accum=accum)


def _unflatten(tree, leaves: list, pos: list):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves, pos) for k in sorted(tree)}
    pos[0] += 1
    return leaves[pos[0] - 1]


def unflatten(like, leaves: list):
    """A tree of ``like``'s nesting whose leaves, in flatten order (sorted
    keys), are ``leaves``."""
    return _unflatten(like, list(leaves), [0])


def grads_of(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads): ``loss_fn`` and the gradient of its loss
    with respect to every leaf of ``params`` (zeros for a leaf the loss
    does not depend on), the leaves' dtypes. Runs under autograd whatever
    the caller's grad mode."""
    leaves = [p for _, p in params_lib.tree_leaves(params)]
    with torch.enable_grad():
        req = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = T.loss_fn(cfg, unflatten(params, req), batch)
        grads = torch.autograd.grad(loss, req, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tc: TrainConfig, sketch=None):
    """Returns train_step(state, batch) -> (state, metrics); metrics
    ``ce``, ``aux``, ``tokens`` (only ``ce`` with accumulation, as the
    reference), ``comm_ratio`` (with compression), ``grad_norm``, ``lr``
    and ``loss``, as 0-d tensors."""

    def train_step(state: TrainState, batch):
        if tc.grad_accum > 1:
            n = tc.grad_accum
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.opt.step.device)
            grads = params_lib.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), state.params)
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                mloss, _, g = grads_of(cfg, state.params, mb)
                loss = loss + mloss
                for (_, acc), (_, gi) in zip(params_lib.tree_leaves(grads),
                                             params_lib.tree_leaves(g)):
                    acc.add_(gi)
                del g
            loss = loss / n
            for _, acc in params_lib.tree_leaves(grads):
                acc.div_(n)
            metrics = {"ce": loss}
        else:
            loss, metrics, grads = grads_of(cfg, state.params, batch)

        cstate = state.compressor
        if tc.compression is not None:
            grads, cstate, cm = comp_lib.roundtrip(
                tc.compression, sketch, cstate, grads,
                step=int(state.opt.step))
            metrics = {**metrics, **cm}

        params, opt, om = opt_lib.update(tc.adamw, grads, state.opt,
                                         state.params)
        metrics = {**metrics, **om, "loss": loss}
        return TrainState(params=params, opt=opt, compressor=cstate), metrics

    return train_step
