"""LSH attention: the paper's CP-SRP (Definition 12) applied to long context
(reference: ``repro.models.lsh_attention``).

Each head vector in R^{hd} is viewed as a 2-mode tensor (hd = m1 x m2) and
hashed with K CP-Rademacher projection tensors of rank R (Definition 6):
code bit k = sign(<P_k, reshape(x)>), bucket id = packed K bits. Queries and
keys that share a bucket are likely to have high cosine similarity (Theorem
8), so attention is restricted to bucket-mates:

  * prefill: sort tokens by (bucket, position) per head, attend within
    consecutive chunks + one look-back chunk (Reformer-style), causal on
    the ORIGINAL positions; unsort. O(S * chunk) instead of O(S^2).
  * decode: O(S) integer code-match against the cache + top-C candidate
    selection (forced recency window), then exact attention over C keys.

The decode candidates are the first C of a stable descending sort of the
reference's float32 selection score (``layers.top_k``: ``jax.lax.top_k``
keeps the lower index among equal scores, and the score's ties are
common: reference caveat R7); a decode past the cache's last slot raises where the
reference's ``dynamic_update_slice`` clamps onto the last slot (R8), and
a decode writes its token's K/V and code before it selects, so the token
is among its own candidates as in prefill (the reference selects first,
R9).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import shard
from repro_torch.models.attention import NEG_INF, qkv_proj
from repro_torch.models.layers import norm, top_k

PAD_CODE = 1 << 30
PAD_POS = (2 ** 31 - 1) // 2


class LSHKVCache(NamedTuple):
    k: torch.Tensor      # (B, W, KV, hd)
    v: torch.Tensor      # (B, W, KV, hd)
    codes: torch.Tensor  # (B, W, KV) int32 bucket ids of cached keys


def srp_values(x: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor
               ) -> torch.Tensor:
    """x (..., hd) -> (..., K) float32 CP-Rademacher projections
    (1/sqrt(R)) sum_{i,j} x[i,j] sum_r sign(f1)[k,i,r] sign(f2)[k,j,r]
    (in float64 where x is float64)."""
    _, m1, r = f1.shape
    m2 = f2.shape[1]
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    a1 = torch.sign(f1.to(ft))
    a2 = torch.sign(f2.to(ft))
    x2 = x.to(ft).reshape(x.shape[:-1] + (m1, m2))
    t = torch.einsum("...ij,kjr->...kir", x2, a2)
    return torch.einsum("...kir,kir->...k", t, a1) / math.sqrt(r)


def srp_bucket_codes(x: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor
                     ) -> torch.Tensor:
    """x (..., hd) -> int32 bucket ids via CP-SRP (Defs 6, 12).

    f1 (K, m1, R), f2 (K, m2, R): Gaussian params sign()-ed to Rademacher;
    bit k is ``srp_values(x)[..., k] > 0``."""
    k = f1.shape[0]
    bits = (srp_values(x, f1, f2) > 0).to(torch.int32)
    weights = 1 << torch.arange(k, dtype=torch.int32, device=x.device)
    return torch.sum(bits * weights, dim=-1, dtype=torch.int32)


def _sort_by(perm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Gather along the S axis; x (B,H,S,...), perm (B,H,S)."""
    idx = perm.reshape(perm.shape + (1,) * (x.ndim - perm.ndim))
    return torch.gather(x, 2, idx.expand(perm.shape + x.shape[3:]))


def _bucket_order(codes: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The permutation sorting each row by (bucket, position), ties in
    their original order (``jnp.lexsort``): one stable sort of
    code * 2^31 + position."""
    key = codes.to(torch.int64) * (1 << 31) + pos.to(torch.int64)
    return torch.sort(key, dim=-1, stable=True).indices


def lsh_attention_prefill(cfg: ModelConfig, proj: dict, q, k, v, positions):
    """q (B,S,H,hd), k/v (B,S,KV,hd) -> out (B,S,H,hd). O(S * lsh_chunk)."""
    b, s_orig, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    c = min(cfg.lsh_chunk, s_orig)
    scale = 1.0 / math.sqrt(hd)

    # pad S to a multiple of the chunk; padded tokens get positions beyond
    # the sequence (causally invisible to real queries) and max bucket codes
    # (sort to the end); padded query rows are sliced off after unsorting.
    pad = (-s_orig) % c
    if pad:
        widths = (0, 0, 0, 0, 0, pad)
        q = torch.nn.functional.pad(q, widths)
        k = torch.nn.functional.pad(k, widths)
        v = torch.nn.functional.pad(v, widths)
        positions = torch.nn.functional.pad(positions, (0, pad),
                                            value=PAD_POS)
    s = s_orig + pad

    # bucket codes; keys hashed per kv head then repeated over the group
    qc = srp_bucket_codes(q, proj["f1"], proj["f2"])              # (B,S,H)
    kc = srp_bucket_codes(k, proj["f1"], proj["f2"]).repeat_interleave(
        g, dim=2)                                                  # (B,S,H)
    if pad:
        pad_mask = (torch.arange(s, device=q.device) >= s_orig)[None, :, None]
        qc = torch.where(pad_mask, PAD_CODE, qc)
        kc = torch.where(pad_mask, PAD_CODE, kc)

    # head-major layout
    qh = q.movedim(2, 1)                                           # (B,H,S,hd)
    kh = k.repeat_interleave(g, dim=2).movedim(2, 1)
    vh = v.repeat_interleave(g, dim=2).movedim(2, 1)
    qch = qc.movedim(2, 1)                                         # (B,H,S)
    kch = kc.movedim(2, 1)
    pos_b = positions[:, None, :].expand(b, h, s)

    qperm = _bucket_order(qch, pos_b)
    kperm = _bucket_order(kch, pos_b)
    qs = _sort_by(qperm, qh).float() * scale
    ks = _sort_by(kperm, kh).float()
    vs = _sort_by(kperm, vh).float()
    qpos = torch.gather(pos_b, 2, qperm)
    kpos = torch.gather(pos_b, 2, kperm)

    nc = s // c
    qs = qs.reshape(b, h, nc, c, hd)
    ks = ks.reshape(b, h, nc, c, hd)
    vs = vs.reshape(b, h, nc, c, hd)
    qpos_c = qpos.reshape(b, h, nc, c)
    kpos_c = kpos.reshape(b, h, nc, c)

    # each q chunk sees its own + the previous k chunk (wrap masked causally)
    k2 = torch.cat([torch.roll(ks, 1, dims=2), ks], dim=3)         # (B,H,nc,2c,hd)
    v2 = torch.cat([torch.roll(vs, 1, dims=2), vs], dim=3)
    kp2 = torch.cat([torch.roll(kpos_c, 1, dims=2), kpos_c], dim=3)

    sc = torch.einsum("bhnqd,bhnkd->bhnqk", qs, k2)
    causal = kp2[:, :, :, None, :] <= qpos_c[..., None]
    sc = torch.where(causal, sc, NEG_INF)
    # a token always sees at least itself (same bucket, same chunk)
    p = torch.softmax(sc, dim=-1)
    out_s = torch.einsum("bhnqk,bhnkd->bhnqd", p, v2).reshape(b, h, s, hd)

    # unsort (the inverse permutation), drop padding rows
    inv = torch.empty_like(qperm).scatter_(
        2, qperm, torch.arange(s, device=q.device).expand(b, h, s))
    out = _sort_by(inv, out_s)
    return out.movedim(1, 2).to(q.dtype)[:, :s_orig]               # (B,S,H,hd)


def lsh_attention_decode(cfg: ModelConfig, proj: dict, q, cache: LSHKVCache,
                         cache_pos, cur_pos: int):
    """q (B,1,H,hd) over a full-length hashed cache. O(S) match + O(C) attn."""
    b, _, h, hd = q.shape
    w, kvh = cache.k.shape[1], cache.k.shape[2]
    g = h // kvh
    cand = min(cfg.lsh_candidates, w)
    scale = 1.0 / math.sqrt(hd)

    qc = srp_bucket_codes(q, proj["f1"], proj["f2"])[:, 0]         # (B,H)
    kc = cache.codes.repeat_interleave(g, dim=2)                   # (B,W,H)

    valid = (cache_pos >= 0) & (cache_pos <= cur_pos)              # (W,)
    match = (kc == qc[:, None, :]) & valid[None, :, None]
    recent = ((cur_pos - cache_pos) < cfg.lsh_recent) & valid      # (W,)

    # selection score: recency dominates, then bucket match, newer first
    # (float32, as the reference: positions past 2^24 share scores)
    sel = (recent[None, :, None].float() * 4e9
           + match.float() * 2e9
           + cache_pos[None, :, None].float())
    sel = torch.where(valid[None, :, None], sel, -1.0)
    _, idx = top_k(sel.movedim(1, 2), cand)                        # (B,H,C)

    # gather the C candidates per kv head along W (q heads are contiguous
    # per kv head), never the group-repeated (B, W, H, hd) copy
    idx_kv = idx.reshape(b, kvh, g * cand, 1).expand(b, kvh, g * cand, hd)
    kg = torch.gather(cache.k.transpose(1, 2), 2, idx_kv).reshape(
        b, h, cand, hd)
    vg = torch.gather(cache.v.transpose(1, 2), 2, idx_kv).reshape(
        b, h, cand, hd)
    attendable = torch.gather((match | recent[None, :, None]).movedim(1, 2),
                              2, idx)

    qf = q[:, 0].float() * scale                                   # (B,H,hd)
    sc = torch.einsum("bhd,bhcd->bhc", qf, kg.float())
    sc = torch.where(attendable, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhc,bhcd->bhd", p, vg.float())
    return out[:, None].to(q.dtype)                                # (B,1,H,hd)


def lsh_attention_block(cfg: ModelConfig, lp: dict, proj: dict, x, positions,
                        *, cache: LSHKVCache | None = None, cache_pos=None,
                        cur_pos: int | None = None):
    """Drop-in attention sub-block using CP-SRP bucketing. Returns
    (residual_delta, new_cache); a decode writes its slot in place, then
    selects over the cache with it (``cache_pos`` marked by the caller)."""
    h = norm(cfg, x, lp["ln"])
    q, k, v = qkv_proj(cfg, lp, h, positions)
    if cache is None:
        out = lsh_attention_prefill(cfg, proj, q, k, v, positions)
        codes = srp_bucket_codes(k, proj["f1"], proj["f2"])
        new_cache = LSHKVCache(
            k=shard(k, "batch", "kv_seq", "kv_heads", None),
            v=shard(v, "batch", "kv_seq", "kv_heads", None),
            codes=shard(codes, "batch", "kv_seq", "kv_heads"))
    else:
        w = cache.k.shape[1]
        if not 0 <= cur_pos < w:
            raise ValueError(
                f"LSH decode at position {cur_pos} past the cache's {w} "
                "slots (the cache is full-length, not a ring; the "
                "reference would overwrite its last slot: caveat R8)")
        cache.k[:, cur_pos] = k[:, 0]   # full-length cache, no ring
        cache.v[:, cur_pos] = v[:, 0]
        cache.codes[:, cur_pos] = srp_bucket_codes(
            k, proj["f1"], proj["f2"])[:, 0]
        out = lsh_attention_decode(cfg, proj, q, cache, cache_pos, cur_pos)
        new_cache = cache
    b, s = out.shape[0], out.shape[1]
    y = out.reshape(b, s, -1) @ lp["wo"]
    return y, new_cache
