"""Attention: GQA/MHA/MQA with RoPE, flash-style chunked softmax for
prefill, ring-buffer sliding-window KV caches, and cache decode (reference:
``repro.models.attention``).

Prefill never materializes (S, T) score matrices: a loop over KV chunks
carries the online-softmax state (m, l, acc) in float32, so activation
memory is O(S * kv_chunk) per head. Sliding-window archs (mixtral) keep
only window-sized ring caches. The softmax is the reference's float32
expression, not ``scaled_dot_product_attention`` (another reduction order).

A decode step writes its token's K/V into the cache's tensors in place
(the reference's launcher donates the cache for the same effect), then
attends over the cache with that slot included, so the token sees itself
as it does in the forward pass. The reference attends before it writes,
so its decode leaves the token's own key out (reference caveat R9: a
decode step then differs from the forward pass by the diagonal term).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models.layers import norm, rope

NEG_INF = -1e30


class KVCache(NamedTuple):
    """Per-layer decode cache (stacked over layers by the caller)."""
    k: torch.Tensor  # (B, W, KV, hd)
    v: torch.Tensor  # (B, W, KV, hd)


def qkv_proj(cfg: ModelConfig, lp: dict, x: torch.Tensor, positions,
             pre: str = ""):
    """x (B,S,D) -> q (B,S,H,hd), k,v (B,S,KV,hd), roped."""
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ lp[pre + "wq"]).reshape(b, s, h, hd)
    k = (x @ lp[pre + "wk"]).reshape(b, s, kv, hd)
    v = (x @ lp[pre + "wv"]).reshape(b, s, kv, hd)
    if cfg.use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool,
                      window: int = 0, kv_chunk: int = 512) -> torch.Tensor:
    """Flash-style attention. q (B,S,H,hd); k,v (B,T,KV,hd);
    q_pos (B,S) / k_pos (B,T) int32, padded k positions = -1.

    KV heads are repeated to H per chunk (the query head dim stays intact,
    as in the reference)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qf = q.float() * scale

    pad = (-t) % kv_chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)

    m = torch.full((b, s, h), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, s, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
    # one split a tensor: its backward concatenates the chunks' gradients
    # once, where slicing would write a zero-filled K-sized one a chunk
    for kc, vc, kpj in zip(k.split(kv_chunk, dim=1), v.split(kv_chunk, dim=1),
                           k_pos.split(kv_chunk, dim=1)):
        args = (qf, kc, vc, kpj, q_pos, m, l, acc, g, causal, window)
        if torch.is_grad_enabled():
            # the backward recomputes the chunk's scores and
            # probabilities, as the reference's jax.checkpoint on its
            # chunk body: saved, the (B, S, H, C) float32 probabilities
            # of every chunk would dominate a layer's training memory
            m, l, acc = torch.utils.checkpoint.checkpoint(
                _chunk_step, *args, use_reentrant=False)
        else:
            m, l, acc = _chunk_step(*args)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _chunk_step(qf, kc, vc, kpj, q_pos, m, l, acc, g: int, causal: bool,
                window: int):
    """One KV chunk of the online softmax: (m, l, acc) updated."""
    kr = kc.float()
    vr = vc.float()
    if g > 1:
        kr = kr.repeat_interleave(g, dim=2)
        vr = vr.repeat_interleave(g, dim=2)
    sc = torch.einsum("bshd,bchd->bshc", qf, kr)
    valid = kpj[:, None, :] >= 0                            # (B, 1, C)
    if causal:
        valid = valid & (kpj[:, None, :] <= q_pos[:, :, None])
    if window:
        valid = valid & ((q_pos[:, :, None] - kpj[:, None, :]) < window)
    sc = torch.where(valid[:, :, None, :], sc, NEG_INF)
    m_new = torch.maximum(m, sc.amax(dim=-1))
    p = torch.exp(sc - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bshc,bchd->bshd", p, vr)
    return m_new, l, acc


def decode_attention(q, cache_k, cache_v, cache_pos, cur_pos: int, *,
                     window: int = 0) -> torch.Tensor:
    """One-token attention over a (ring) cache.
    q (B,1,H,hd); cache_k/v (B,W,KV,hd); cache_pos (W,) int32 (-1 = empty)."""
    b, _, h, hd = q.shape
    kvh = cache_k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kvh, g, hd).float() * scale
    sc = torch.einsum("bkgh,bwkh->bkgw", qg, cache_k.float())
    valid = (cache_pos >= 0) & (cache_pos <= cur_pos)
    if window:
        valid = valid & ((cur_pos - cache_pos) < window)
    sc = torch.where(valid[None, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgw,bwkh->bkgh", p, cache_v.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def cache_window(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def write_cache(cache: KVCache, k, v, cur_pos: int) -> KVCache:
    """Write one decoded token's k/v at slot cur_pos % W (ring buffer), in
    place."""
    slot = cur_pos % cache.k.shape[1]
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    return cache


def attention_block(cfg: ModelConfig, lp: dict, x, positions, *,
                    causal: bool = True, window: int = 0,
                    cache: KVCache | None = None, cache_pos=None,
                    cur_pos: int | None = None, pre: str = ""):
    """Pre-norm attention sub-block. Returns (residual_delta, new_cache).

    Prefill: cache is None -> chunked flash attention over the batch, and
    the sequence's K/V come back as the new cache. Decode: cache given, x
    is (B, 1, D): the token's K/V go into slot cur_pos % W first, then it
    attends over the ring with ``cache_pos`` (which the caller has marked
    with cur_pos) (R9)."""
    h = norm(cfg, x, lp[pre + "ln"])
    q, k, v = qkv_proj(cfg, lp, h, positions, pre=pre)
    if cache is None:
        out = chunked_attention(q, k, v, positions, positions,
                                causal=causal, window=window)
        new_cache = KVCache(shard(k, "batch", "kv_seq", "kv_heads", None),
                            shard(v, "batch", "kv_seq", "kv_heads", None))
    else:
        new_cache = write_cache(cache, k, v, cur_pos)
        out = decode_attention(q, cache.k, cache.v, cache_pos, cur_pos,
                               window=window)
    out = shard(out, "batch", "seq", "heads", None)
    b, s = out.shape[0], out.shape[1]
    y = out.reshape(b, s, -1) @ lp[pre + "wo"]
    return y, new_cache


def cross_attention_block(cfg: ModelConfig, lp: dict, x, enc_k, enc_v,
                          enc_pos):
    """Decoder cross-attention over precomputed encoder K/V (whisper)."""
    h = norm(cfg, x, lp["xln"])
    b, s, _ = x.shape
    q = (h @ lp["xwq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    out = chunked_attention(
        q, enc_k, enc_v, torch.zeros((b, s), dtype=torch.int32,
                                     device=x.device),
        enc_pos, causal=False)
    return out.reshape(b, s, -1) @ lp["xwo"]


def encode_kv(cfg: ModelConfig, lp: dict, enc_out: torch.Tensor):
    """Project encoder output to cross-attention K/V once (cached)."""
    b, t, _ = enc_out.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    k = (enc_out @ lp["xwk"]).reshape(b, t, kv, hd)
    v = (enc_out @ lp["xwv"]).reshape(b, t, kv, hd)
    return k, v
