"""Shared layers: norms, RoPE, activations, MLPs, embedding (reference:
``repro.models.layers``), and the top-k rule of ``jax.lax.top_k``.

The cast points are the reference's: a norm is computed in float32, cast to
the input's dtype and then multiplied by its scale in that dtype; RoPE
rotates in float32 and casts back; the projections take the operands'
dtype (bfloat16 products accumulate in float32, see ``repro_torch``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dt) * scale


def norm(cfg: ModelConfig, x: torch.Tensor, scale: torch.Tensor
         ) -> torch.Tensor:
    return rmsnorm(x, scale) if cfg.norm == "rmsnorm" else layernorm(x, scale)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embeddings. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(cfg: ModelConfig, gate: torch.Tensor,
               up: torch.Tensor | None) -> torch.Tensor:
    if cfg.act == "swiglu":
        return F.silu(gate) * up
    if cfg.act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    return F.gelu(gate, approximate="tanh")


def mlp(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense FFN with pre-norm. x: (B, S, D)."""
    h = norm(cfg, x, lp["mlp_ln"])
    if cfg.act in ("swiglu", "geglu"):
        a = activation(cfg, h @ lp["wi_gate"], h @ lp["wi_up"])
    else:
        a = activation(cfg, h @ lp["wi"], None)
    a = shard(a, "batch", "seq", "mlp")
    return a @ lp["mlp_wo"]


def embed_tokens(cfg: ModelConfig, params: dict, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = params["embed"]["tokens"][tokens]
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return shard(x, "batch", "seq", "embed")


def lm_logits(cfg: ModelConfig, params: dict, x: torch.Tensor
              ) -> torch.Tensor:
    x = norm(cfg, x, params["final_norm"])
    head = (params["embed"]["tokens"].T if cfg.tie_embeddings
            else params["lm_head"])
    return shard(x @ head, "batch", "seq", "vocab")


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal
    values in index order: ``jax.lax.top_k``'s rule (``torch.topk``
    promises no order among ties), by a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
