"""Mixture-of-Experts FFN: capacity-bounded slot dispatch (reference:
``repro.models.moe``).

  * router top-k, softmax over the selected logits (mixtral-style); the
    top-k keeps the lower expert index among equal logits, as
    ``jax.lax.top_k`` does (``layers.top_k``);
  * every (token, choice) assignment gets a rank within its expert from a
    one-hot cumulative sum in arrival order; assignments past the expert
    capacity C = max(ceil(T*k/E * capacity_factor), 4) are dropped, so the
    drops depend on the batch's token count T;
  * the kept rows are written into an (E, C, D) dispatch buffer;
  * expert FFNs run as batched matmuls (E, C, D) x (E, D, F);
  * results gather back by slot and combine weighted by the gates.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models.layers import activation, norm, top_k


class Routing(NamedTuple):
    top_idx: torch.Tensor   # (T, k) int64 chosen experts
    gates: torch.Tensor     # (T, k) softmax over the chosen logits, x.dtype
    probs: torch.Tensor     # (T, E) float32 router softmax
    keep: torch.Tensor      # (T*k,) bool: the assignment fits its capacity
    slot: torch.Tensor      # (T*k,) int64 row of the dispatch buffer
    capacity: int


def route(cfg: ModelConfig, lp: dict, ht: torch.Tensor) -> Routing:
    """Router, top-k, gates and capacity slots for ht (T, D) (normed)."""
    t = ht.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = (ht @ lp["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_logits, top_idx = top_k(logits, k)                  # (T, k)
    gates = torch.softmax(top_logits, dim=-1).to(ht.dtype)
    capacity = max(int(math.ceil(t * k / e * cfg.capacity_factor)), 4)
    flat_e = top_idx.reshape(t * k)
    onehot = torch.nn.functional.one_hot(flat_e, e)         # (T*k, E)
    ranks = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = ranks < capacity
    slot = torch.where(keep, flat_e * capacity + ranks,
                       torch.iinfo(torch.int32).max)
    return Routing(top_idx, gates, probs, keep, slot, capacity)


def moe_block(cfg: ModelConfig, lp: dict, x: torch.Tensor):
    """x (B,S,D) -> (out (B,S,D), aux_loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    h = norm(cfg, x, lp["mlp_ln"])
    ht = h.reshape(b * s, d)
    t = b * s
    r = route(cfg, lp, ht)

    # load-balance aux loss (Switch/Mixtral): E * sum_e f_e * p_e
    me = r.probs.mean(dim=0)                                # (E,)
    ce = torch.nn.functional.one_hot(r.top_idx, e).float().sum(dim=1).mean(
        dim=0)
    aux_loss = e * torch.sum(me * ce)

    # dispatch: the kept assignments' rows into their slots (the
    # reference's scatter with mode="drop"); other slots stay zero
    tok_of = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e * r.capacity, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, r.slot[r.keep], ht[tok_of[r.keep]])
    xe = shard(buf.reshape(e, r.capacity, d), "expert", "capacity", "moe_d")

    # expert FFN (batched matmuls)
    a = activation(cfg, torch.bmm(xe, lp["we_gate"]),
                   torch.bmm(xe, lp["we_up"]))
    a = shard(a, "expert", "capacity", "mlp")
    ye = torch.bmm(a, lp["we_down"])

    # combine: gather by slot, weight by gate, sum over the k choices
    yflat = ye.reshape(e * r.capacity, d)
    safe_slot = torch.clamp(r.slot, max=e * r.capacity - 1)
    per_choice = yflat[safe_slot] * (r.gates.reshape(t * k, 1)
                                     * r.keep[:, None].to(ye.dtype))
    out = per_choice.reshape(t, k, d).sum(dim=1)

    if cfg.n_shared_experts:
        out = out + activation(cfg, ht @ lp["ws_gate"],
                               ht @ lp["ws_up"]) @ lp["ws_down"]
    return out.reshape(b, s, d), aux_loss


def moe_block_dense_reference(cfg: ModelConfig, lp: dict, x: torch.Tensor):
    """O(E x tokens) reference: every expert on every token, masked combine
    (no capacity drops). Used only to validate the dispatch path."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    h = norm(cfg, x, lp["mlp_ln"])
    ht = h.reshape(b * s, d)
    logits = (ht @ lp["router"]).float()
    top_logits, top_idx = top_k(logits, k)
    gates = torch.softmax(top_logits, dim=-1)
    g = torch.einsum("td,edf->etf", ht, lp["we_gate"])
    u = torch.einsum("td,edf->etf", ht, lp["we_up"])
    ye = torch.einsum("etf,efd->etd", activation(cfg, g, u), lp["we_down"])
    weights = torch.zeros((b * s, e), dtype=torch.float32, device=x.device)
    weights.scatter_add_(1, top_idx, gates)
    out = torch.einsum("te,etd->td", weights.to(ye.dtype), ye)
    if cfg.n_shared_experts:
        out = out + activation(cfg, ht @ lp["ws_gate"],
                               ht @ lp["ws_up"]) @ lp["ws_down"]
    return out.reshape(b, s, d)
