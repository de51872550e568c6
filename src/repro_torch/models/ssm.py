"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) blocks (reference:
``repro.models.ssm``).

Prefill uses the chunked SSD algorithm: quadratic attention-like
intra-chunk term + a linear inter-chunk state recurrence (a loop over
chunks). Decode is the O(1) recurrent update on a (H, P, N) state.

Layout: d_inner = expand * d_model, H = d_inner / head_dim heads, state dim
N per head, G groups for B/C. The conv is a causal depthwise width-4 conv
over the concatenated [x, B, C] streams, as in Mamba2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import shard
from repro_torch.models.layers import norm, rmsnorm
from repro_torch.models.params import torch_dtype


class SSMCache(NamedTuple):
    state: torch.Tensor  # (B, H, P, N) f32
    conv: torch.Tensor   # (B, W-1, CH) — last conv_width-1 pre-activation inputs


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    din = cfg.d_inner
    gs = cfg.ssm_groups * cfg.ssm_state
    sh = xbc.shape[:-1]
    x = xbc[..., :din].reshape(sh + (cfg.ssm_heads, cfg.ssm_head_dim))
    bmat = xbc[..., din:din + gs].reshape(sh + (cfg.ssm_groups,
                                                cfg.ssm_state))
    cmat = xbc[..., din + gs:].reshape(sh + (cfg.ssm_groups, cfg.ssm_state))
    return x, bmat, cmat


def _rep_groups(cfg: ModelConfig, m: torch.Tensor) -> torch.Tensor:
    """(..., G, N) -> (..., H, N) by repeating each group over its heads."""
    return m.repeat_interleave(cfg.ssm_heads // cfg.ssm_groups, dim=-2)


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,CH), w (W,CH) -> (B,S,CH)."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out


def ssd_chunked(x, dt, a, bmat, cmat, chunk: int, init_state=None):
    """Chunked SSD scan.

    x (B,S,H,P), dt (B,S,H) [post-softplus], a (H,) [negative],
    bmat/cmat (B,S,H,N) [already group-repeated]. Returns (y (B,S,H,P),
    final_state (B,H,P,N)).
    """
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    dtype = x.dtype
    x, dt, bmat, cmat = x.float(), dt.float(), bmat.float(), cmat.float()

    pad = (-s) % chunk
    if pad:  # zero dt => exp(0)=1 decay, zero input: padding is exact
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    bc = bmat.reshape(b, nc, chunk, h, n)
    cc = cmat.reshape(b, nc, chunk, h, n)

    da = dtc * a  # (b, nc, q, h), negative
    cs = torch.cumsum(da, dim=2)  # inclusive cumulative decay within chunk

    # ---- intra-chunk (masked attention-like term) ----
    # M[i, j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j   for i >= j
    scores = torch.einsum("bcihn,bcjhn->bchij", cc, bc)
    li = cs.permute(0, 1, 3, 2)  # (b, nc, h, q)
    ldiff = li[..., :, None] - li[..., None, :]  # cs_i - cs_j
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    # exp of the masked entries' -inf, not where(mask, exp(ldiff), 0): above
    # the diagonal ldiff is a sum of |dt * a| that passes float32's exp
    # range over a 256-token chunk, and the backward of the reference's
    # form multiplies that inf by the zero cotangent (NaN gradients,
    # caveat R11). The forward values are the same.
    decay = torch.exp(torch.where(mask, ldiff, float("-inf")))
    m = scores * decay * dtc.permute(0, 1, 3, 2)[..., None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", m, xc)

    # ---- chunk states ----
    # S_c = sum_j exp(cs_last - cs_j) dt_j B_j (x) x_j  -> (b, nc, h, p, n)
    w = torch.exp(cs[:, :, -1:, :] - cs) * dtc  # (b, nc, q, h)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", w, bc, xc)

    # ---- inter-chunk recurrence: the state entering each chunk ----
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (b, nc, h)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)

    # ---- inter-chunk contribution ----
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           cc * torch.exp(cs)[..., None], prev_states)

    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)[:, :s]
    return y.to(dtype), carry


def ssd_decode_step(state, x, dt, a, bmat, cmat):
    """O(1) recurrent update. state (B,H,P,N); x (B,H,P); dt (B,H);
    bmat/cmat (B,H,N). Returns (y (B,H,P), new_state)."""
    da = torch.exp(dt * a)  # (B,H)
    upd = torch.einsum("bh,bhn,bhp->bhpn", dt, bmat, x)
    new_state = state * da[:, :, None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", cmat, new_state)
    return y, new_state


def ssm_block(cfg: ModelConfig, lp: dict, x: torch.Tensor, *,
              cache: SSMCache | None = None):
    """Mamba2 block. Prefill: cache None, x (B,S,D).
    Decode: cache given, x (B,1,D). Returns (y, new_cache)."""
    b, s, d = x.shape
    h = norm(cfg, x, lp["ssm_ln"])
    xbc = shard(h @ lp["w_xBC"], "batch", "seq", "ssm_inner")
    z = h @ lp["w_z"]
    dt_raw = h @ lp["w_dt"]
    a = -torch.exp(lp["A_log"].float())  # (H,)
    dt = F.softplus(dt_raw.float() + lp["dt_bias"].float())

    if cache is None:
        xbc_act = F.silu(causal_conv(xbc, lp["conv_w"]))
        xs, bm, cm = _split_xbc(cfg, xbc_act)
        y, final_state = ssd_chunked(xs, dt, a, _rep_groups(cfg, bm),
                                     _rep_groups(cfg, cm), cfg.ssm_chunk)
        wminus1 = cfg.conv_width - 1
        tail = (xbc[:, -wminus1:, :] if s >= wminus1
                else F.pad(xbc, (0, 0, wminus1 - s, 0)))
        new_cache = SSMCache(state=final_state, conv=tail)
        y = y + lp["ssm_D"].float()[None, None, :, None] * xs.float()
    else:
        window = torch.cat([cache.conv, xbc], dim=1)  # (B, W, CH)
        conv_out = torch.einsum("bwc,wc->bc", window, lp["conv_w"])[:, None]
        xs, bm, cm = _split_xbc(cfg, F.silu(conv_out))
        x1 = xs[:, 0]
        y1, new_state = ssd_decode_step(
            cache.state, x1.float(), dt[:, 0], a,
            _rep_groups(cfg, bm)[:, 0].float(),
            _rep_groups(cfg, cm)[:, 0].float())
        y1 = y1 + lp["ssm_D"].float()[None, :, None] * x1.float()
        y = y1[:, None]
        new_cache = SSMCache(state=new_state, conv=window[:, 1:])

    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), lp["norm_z"])
    return y @ lp["out_proj"], new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cuda") -> SSMCache:
    dev = resolve_device(device)
    return SSMCache(
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=torch.float32, device=dev),
        conv=torch.zeros((batch, cfg.conv_width - 1, cfg.conv_channels),
                         dtype=torch_dtype(cfg), device=dev),
    )
