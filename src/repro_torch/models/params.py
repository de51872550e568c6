"""Parameter specs: the single source of truth for shapes, logical sharding
axes and init of every architecture's parameters (reference:
``repro.models.params``).

`param_specs(cfg)` returns a nested dict of ParamSpec, the reference's tree
key for key; `init_params` / `abstract_params` / `param_axes` are derived
views, so shapes, shardings and initialization can never drift apart.
Per-layer weights carry a leading `n_layers` dim ("layers") and are walked
layer by layer by the models.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

# elements drawn at a time for a normal leaf (256 MB of float32): llama4's
# expert stacks are (L/2, 128, 5120, 8192), and a whole float32 draw of
# even one layer's slice would not fit beside the weights on one card
DRAW_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"      # normal | zeros | ones | ssm_a | ssm_dt
    scale: float = 0.02


def _attn_specs(cfg: ModelConfig, layers: int | None, cross: bool = False
                ) -> dict:
    """Attention weights; leading layers dim if `layers` given."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    pre = "x" if cross else ""
    return {
        f"{pre}ln": ParamSpec(L + (d,), lax_ + ("embed",), init="ones"),
        f"{pre}wq": ParamSpec(L + (d, h * hd), lax_ + ("fsdp_embed", "heads")),
        f"{pre}wk": ParamSpec(L + (d, kv * hd),
                              lax_ + ("fsdp_embed", "kv_heads")),
        f"{pre}wv": ParamSpec(L + (d, kv * hd),
                              lax_ + ("fsdp_embed", "kv_heads")),
        f"{pre}wo": ParamSpec(L + (h * hd, d), lax_ + ("heads", "fsdp_embed"),
                              scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def _mlp_specs(cfg: ModelConfig, layers: int | None, d_ff: int = 0) -> dict:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    L = (layers,) if layers else ()
    lax_ = ("layers",) if layers else ()
    out = {"mlp_ln": ParamSpec(L + (d,), lax_ + ("embed",), init="ones")}
    if cfg.act in ("swiglu", "geglu"):
        out["wi_gate"] = ParamSpec(L + (d, f), lax_ + ("fsdp_embed", "mlp"))
        out["wi_up"] = ParamSpec(L + (d, f), lax_ + ("fsdp_embed", "mlp"))
    else:
        out["wi"] = ParamSpec(L + (d, f), lax_ + ("fsdp_embed", "mlp"))
    out["mlp_wo"] = ParamSpec(L + (f, d), lax_ + ("mlp", "fsdp_embed"),
                              scale=0.02 / math.sqrt(2 * cfg.n_layers))
    return out


def _moe_specs(cfg: ModelConfig, layers: int) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    L, lax_ = (layers,), ("layers",)
    out = {
        "mlp_ln": ParamSpec(L + (d,), lax_ + ("embed",), init="ones"),
        "router": ParamSpec(L + (d, e), lax_ + ("embed", None)),
        "we_gate": ParamSpec(L + (e, d, f),
                             lax_ + ("expert", "fsdp_embed", "mlp")),
        "we_up": ParamSpec(L + (e, d, f),
                           lax_ + ("expert", "fsdp_embed", "mlp")),
        "we_down": ParamSpec(L + (e, f, d),
                             lax_ + ("expert", "mlp", "fsdp_embed"),
                             scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        out["ws_gate"] = ParamSpec(L + (d, fs), lax_ + ("fsdp_embed", "mlp"))
        out["ws_up"] = ParamSpec(L + (d, fs), lax_ + ("fsdp_embed", "mlp"))
        out["ws_down"] = ParamSpec(L + (fs, d), lax_ + ("mlp", "fsdp_embed"),
                                   scale=0.02 / math.sqrt(2 * cfg.n_layers))
    return out


def _ssm_specs(cfg: ModelConfig, layers: int) -> dict:
    d, din, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gs = cfg.ssm_groups * cfg.ssm_state
    L, lax_ = (layers,), ("layers",)
    return {
        "ssm_ln": ParamSpec(L + (d,), lax_ + ("embed",), init="ones"),
        "w_xBC": ParamSpec(L + (d, din + 2 * gs),
                           lax_ + ("fsdp_embed", "ssm_inner")),
        "w_z": ParamSpec(L + (d, din), lax_ + ("fsdp_embed", "ssm_inner")),
        "w_dt": ParamSpec(L + (d, h), lax_ + ("fsdp_embed", "ssm_heads")),
        "conv_w": ParamSpec(L + (cfg.conv_width, din + 2 * gs),
                            lax_ + ("conv", "ssm_inner"), scale=0.2),
        "A_log": ParamSpec(L + (h,), lax_ + ("ssm_heads",), init="ssm_a"),
        "ssm_D": ParamSpec(L + (h,), lax_ + ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec(L + (h,), lax_ + ("ssm_heads",), init="ssm_dt"),
        "norm_z": ParamSpec(L + (din,), lax_ + ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec(L + (din, d), lax_ + ("ssm_inner", "fsdp_embed"),
                              scale=0.02 / math.sqrt(2 * cfg.n_layers)),
    }


def param_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab
    specs: dict = {
        "embed": {"tokens": ParamSpec((v, d), ("vocab", "fsdp_embed"))},
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((d, v), ("fsdp_embed", "vocab"))

    L = cfg.n_layers
    if cfg.block == "attn_dense":
        specs["blocks"] = {**_attn_specs(cfg, L), **_mlp_specs(cfg, L)}
    elif cfg.block == "attn_moe":
        lm = L // cfg.moe_every
        specs["blocks"] = {**_attn_specs(cfg, lm), **_moe_specs(cfg, lm)}
        if cfg.moe_every == 2:
            specs["dense_blocks"] = {
                **_attn_specs(cfg, lm),
                **_mlp_specs(cfg, lm, d_ff=cfg.d_ff_dense)}
    elif cfg.block == "ssm":
        specs["blocks"] = _ssm_specs(cfg, L)
    elif cfg.block == "hybrid":
        specs["blocks"] = _ssm_specs(cfg, L)
        specs["shared"] = {**_attn_specs(cfg, None), **_mlp_specs(cfg, None)}
    else:
        raise ValueError(cfg.block)

    if cfg.lsh_attention:
        # CP-SRP projection tensors over the (hd1, hd2)-matricized head dim
        # (paper Definition 6/12): two stacked factor matrices, K = num_hashes.
        m1, m2 = _factor_head_dim(cfg.hd)
        specs["lsh_proj"] = {
            "f1": ParamSpec((cfg.lsh_num_hashes, m1, cfg.lsh_rank),
                            ("lsh_hash", None, "lsh_rank"), scale=1.0),
            "f2": ParamSpec((cfg.lsh_num_hashes, m2, cfg.lsh_rank),
                            ("lsh_hash", None, "lsh_rank"), scale=1.0),
        }

    if cfg.encoder_decoder:
        specs["encoder"] = {
            "pos": ParamSpec((cfg.encoder_seq, d), ("frames", "embed"),
                             scale=0.02),
            "blocks": {**_attn_specs(cfg, cfg.n_encoder_layers),
                       **_mlp_specs(cfg, cfg.n_encoder_layers)},
            "final_norm": ParamSpec((d,), ("embed",), init="ones"),
        }
        # decoder blocks gain cross-attention
        specs["blocks"].update(_attn_specs(cfg, L, cross=True))
        specs["dec_pos"] = ParamSpec((8192, d), (None, "embed"), scale=0.02)
    return specs


def _factor_head_dim(hd: int) -> tuple[int, int]:
    """Split head_dim into two near-square mode dims for the CP projection."""
    m1 = int(math.sqrt(hd))
    while hd % m1:
        m1 -= 1
    return m1, hd // m1


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict, keeping its nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a nested dict in sorted key order (the order
    ``jax.tree.flatten`` gives a dict), paths joined by '/'."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype,
               dev: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ssm_a":
        # A in [1, 16), stored as log: standard mamba2 init
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32,
                       device=dev) * 15.0 + 1.0
        return torch.log(u).to(dtype)
    if spec.init == "ssm_dt":
        # dt bias s.t. softplus(bias) in [1e-3, 1e-1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32,
                       device=dev) * (hi - lo) + lo
        dt = torch.exp(u)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    out = torch.empty(spec.shape, dtype=dtype, device=dev)
    flat = out.view(-1)
    for lo in range(0, flat.numel(), DRAW_CHUNK):
        n = min(DRAW_CHUNK, flat.numel() - lo)
        flat[lo:lo + n] = spec.scale * torch.randn(
            n, generator=gen, dtype=torch.float32, device=dev)
    return out


def init_params(cfg: ModelConfig, gen: torch.Generator, device="cuda"):
    """A parameter tree drawn from ``gen`` (a generator on ``device``) by
    the reference's four laws: ``scale`` times a standard normal, ones /
    zeros, ``ssm_a`` and ``ssm_dt``. Normal leaves are drawn
    ``DRAW_CHUNK`` float32 values at a time into the config's dtype."""
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)
    specs = param_specs(cfg)
    leaves = {path: _init_leaf(s, gen, dtype, dev)
              for path, s in tree_leaves(specs)}
    return _unflatten(specs, leaves)


def _unflatten(specs: dict, leaves: dict, prefix: str = "") -> dict:
    return {k: (_unflatten(v, leaves, f"{prefix}{k}/")
                if isinstance(v, dict) else leaves[f"{prefix}{k}"])
            for k, v in specs.items()}


def abstract_params(cfg: ModelConfig):
    """Meta-device tensors of the parameters' shapes and dtype (no
    allocation), the counterpart of the reference's ShapeDtypeStructs."""
    dtype = torch_dtype(cfg)
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), param_specs(cfg))


def param_axes(cfg: ModelConfig):
    """Tree of logical-axis tuples matching the params tree."""
    return tree_map(lambda s: s.axes, param_specs(cfg))


def count_params(cfg: ModelConfig) -> int:
    return sum(int(np.prod(s.shape))
               for _, s in tree_leaves(param_specs(cfg)))


def count_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: routed top_k + shared experts only)."""
    if not cfg.n_experts:
        return count_params(cfg)
    total = count_params(cfg)
    specs = param_specs(cfg)["blocks"]
    expert_leaves = [v for k, v in specs.items() if k.startswith("we_")]
    expert_total = sum(int(np.prod(s.shape)) for s in expert_leaves)
    active_frac = cfg.top_k / cfg.n_experts
    return int(total - expert_total * (1.0 - active_frac))
