"""Model assembly: decoder-only LM, hybrid Mamba2+shared-attention, and the
Whisper-style encoder-decoder for all 10 archs (reference:
``repro.models.transformer``).

Entry points (all functions of (cfg, params, ...) on a params tree with
the reference's nesting and stacked (L, ...) leaves):
  forward(cfg, params, batch)                  -> logits          (prefill)
  loss_fn(cfg, params, batch)                  -> (loss, metrics) (forward only)
  init_cache(cfg, batch, max_len)              -> cache           (decode)
  prefill(cfg, params, batch, max_len)         -> (logits, cache)
  decode_step(cfg, params, token, cache, pos)  -> (logits, cache) (serving)

The reference's scans over stacked layers are loops over the layer index.
Homogeneous archs walk the stacked params; llama4 walks (dense, MoE)
pairs; the hybrid arch walks groups of `shared_attn_period` Mamba2 layers
followed by one weight-shared attention+MLP block (zamba2). The
full-sequence pass takes its layers by one ``unbind(0)`` a stacked leaf,
so its backward stacks each leaf's gradient once (indexing layer by layer
would write a zero-filled full-size gradient a layer), and wraps each
layer body (a group body for zamba2) in ``_remat``, the counterpart of the
reference's ``jax.checkpoint`` policies. A decode step
writes each layer's new cache entry into the stacked cache in place and
returns the cache; the step marks its position in ``cache.pos`` before
the layers run, so each attention layer sees the token's own slot (R9:
the reference marks it after, and its decode leaves the token's own key
out). ``LM`` holds a params tree as an ``nn.Module``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import shard
from repro_torch.models.attention import (KVCache, attention_block,
                                          cache_window,
                                          cross_attention_block, encode_kv)
from repro_torch.models.layers import embed_tokens, lm_logits, mlp, norm
from repro_torch.models.lsh_attention import LSHKVCache, lsh_attention_block
from repro_torch.models.moe import moe_block
from repro_torch.models.params import torch_dtype
from repro_torch.models.ssm import SSMCache, init_ssm_cache, ssm_block


# ---------------------------------------------------------------------------
# Trees of tensors: dicts of leaves and NamedTuple caches
# ---------------------------------------------------------------------------


def _index(tree, i):
    """Entry ``i`` of every stacked leaf (views, not copies)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_index(v, i) for v in tree)) \
            if hasattr(tree, "_fields") else tuple(_index(v, i) for v in tree)
    return tree[i]


def _unbind(tree) -> list:
    """The layers of a stacked tree: one ``unbind(0)`` a leaf, so autograd
    stacks each leaf's gradient once in the backward."""
    if isinstance(tree, dict):
        cols = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(cols.values())))
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    return list(tree.unbind(0))


def _stack(items):
    """Stack a list of equal trees along a new leading dim."""
    first = items[0]
    if isinstance(first, tuple):
        cols = [_stack([it[j] for it in items]) for j in range(len(first))]
        return type(first)(*cols) if hasattr(first, "_fields") else tuple(cols)
    return torch.stack(items)


def _store(stack, i, new) -> None:
    """Write a layer's new cache into entry ``i`` of the stacked cache,
    skipping leaves the layer already updated in place."""
    for s, n in zip(stack, new):
        dst = s[i]
        if n.data_ptr() != dst.data_ptr():
            dst.copy_(n)


def _reshape_lead(tree, lead: tuple):
    """Reshape every leaf's leading dim to ``lead`` (views)."""
    if isinstance(tree, dict):
        return {k: _reshape_lead(v, lead) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_reshape_lead(v, lead) for v in tree))
    return tree.reshape(lead + tree.shape[1:])


# ---------------------------------------------------------------------------
# Single decoder layer (all block kinds)
# ---------------------------------------------------------------------------


def decoder_layer(cfg: ModelConfig, lp: dict, x, positions, *,
                  layer_cache=None, cache_pos=None, cur_pos=None,
                  enc_kv=None, enc_pos=None, lsh_proj=None):
    """Returns (x, new_layer_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.block in ("ssm", "hybrid"):
        delta, new_cache = ssm_block(cfg, lp, x, cache=layer_cache)
        return shard(x + delta, "batch", "act_seq", "embed"), new_cache, aux

    if cfg.lsh_attention:
        delta, new_cache = lsh_attention_block(
            cfg, lp, lsh_proj, x, positions, cache=layer_cache,
            cache_pos=cache_pos, cur_pos=cur_pos)
    else:
        delta, new_cache = attention_block(
            cfg, lp, x, positions, causal=True, window=cfg.sliding_window,
            cache=layer_cache, cache_pos=cache_pos, cur_pos=cur_pos)
    x = shard(x + delta, "batch", "act_seq", "embed")

    if cfg.encoder_decoder:
        assert enc_kv is not None
        x = x + cross_attention_block(cfg, lp, x, enc_kv[0], enc_kv[1],
                                      enc_pos)

    if cfg.block == "attn_moe":
        delta, aux = moe_block(cfg, lp, x)
    else:
        delta = mlp(cfg, lp, x)
    x = x + delta
    return shard(x, "batch", "act_seq", "embed"), new_cache, aux


# aten products with no batch dims: ``jax.checkpoint_policies.
# dots_with_no_batch_dims_saveable`` saves these and recomputes the rest
# (batched products: bmm, the attention einsums)
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under the config's remat policy when autograd records it:
    "nothing" saves only its inputs and recomputes the body in the
    backward, "dots" also saves the outputs of products with no batch dims
    (``aten.mm`` / ``addmm``), "none" is plain autograd."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "dots":
        context = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat_policy == "nothing":
        context = ckpt.noop_context_fn
    else:
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=context, **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# Stacks (prefill: caches None; collect_kv gathers each layer's K/V)
# ---------------------------------------------------------------------------


def _scan_blocks(cfg: ModelConfig, layers: list, x, positions, *,
                 enc_kv=None, enc_pos=None, lsh_proj=None, collect_kv=False):
    """Homogeneous layer loop over ``layers`` (``_unbind``'s list; the
    cross K/V ``enc_kv`` a list of (k, v) a layer). Returns (x, collected
    kv stacked over layers | None, aux_sum)."""
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    kv = []
    body = _remat(cfg, decoder_layer)
    for i, lp in enumerate(layers):
        x, new_cache, aux = body(
            cfg, lp, x, positions,
            enc_kv=None if enc_kv is None else enc_kv[i], enc_pos=enc_pos,
            lsh_proj=lsh_proj)
        aux_sum = aux_sum + aux
        if collect_kv:
            kv.append(new_cache)
    return x, (_stack(kv) if collect_kv else None), aux_sum


@functools.lru_cache(maxsize=None)
def _dense_view(cfg: ModelConfig) -> ModelConfig:
    """cfg for the interleaved dense layers of a moe_every=2 arch."""
    return dataclasses.replace(cfg, block="attn_dense", d_ff=cfg.d_ff_dense)


def _alt_blocks(cfg: ModelConfig, params, x, positions, *, collect_kv=False):
    """llama4-style alternation: (dense layer, MoE layer) pairs. Collected
    caches come out as one (L, ...) stack, dense layer 2i, MoE 2i + 1."""
    dense_cfg = _dense_view(cfg)

    def pair(lpd, lpm, h):
        h, ncd, a1 = decoder_layer(dense_cfg, lpd, h, positions)
        h, ncm, a2 = decoder_layer(cfg, lpm, h, positions)
        return h, ncd, ncm, a1, a2

    body = _remat(cfg, pair)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    kv = []
    for lpd, lpm in zip(_unbind(params["dense_blocks"]),
                        _unbind(params["blocks"])):
        x, ncd, ncm, a1, a2 = body(lpd, lpm, x)
        aux_sum = aux_sum + a1 + a2
        kv += [ncd, ncm]
    return x, (_stack(kv) if collect_kv else None), aux_sum


def _hybrid_blocks(cfg: ModelConfig, params, x, positions, *,
                   collect_kv=False):
    """zamba2: groups of `period` Mamba2 layers + one shared attn/MLP block.

    Mamba caches come out stacked (G, P, ...); the shared block's K/V
    stacked (G, ...) since each application attends over its own K/V.
    Each Mamba2 layer and each group body is under ``_remat``, as the
    reference's scans are."""
    period = cfg.shared_attn_period
    layers = _unbind(params["blocks"])
    shared = params["shared"]
    inner = _remat(cfg, decoder_layer)

    def group(glayers, h):
        caches, aux_g = [], torch.zeros((), dtype=torch.float32,
                                        device=h.device)
        for lp in glayers:
            h, nc, aux = inner(cfg, lp, h, positions)
            aux_g = aux_g + aux
            caches.append(nc)
        delta, new_s = attention_block(cfg, shared, h, positions,
                                       causal=True,
                                       window=cfg.sliding_window)
        h = h + delta
        h = h + mlp(cfg, shared, h)
        return h, _stack(caches), new_s, aux_g

    body = _remat(cfg, group)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    m_caches, s_caches = [], []
    for gi in range(cfg.n_layers // period):
        x, m_c, new_s, aux = body(layers[gi * period:(gi + 1) * period], x)
        aux_sum = aux_sum + aux
        m_caches.append(m_c)
        s_caches.append(new_s)
    s_stack = _stack(s_caches) if collect_kv else None
    return x, (_stack(m_caches), s_stack), aux_sum


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------


def run_encoder(cfg: ModelConfig, params, frames):
    """frames (B, T, D) precomputed embeddings (stubbed conv frontend)."""
    enc = params["encoder"]
    b, t, _ = frames.shape
    x = frames + enc["pos"][None, :t]
    pos = torch.arange(t, dtype=torch.int32,
                       device=frames.device)[None].expand(b, t)

    def body(lp, h):
        delta, _ = attention_block(cfg, lp, h, pos, causal=False)
        h = h + delta
        return h + mlp(cfg, lp, h)

    body = _remat(cfg, body)
    for lp in _unbind(enc["blocks"]):
        x = body(lp, x)
    return norm(cfg, x, enc["final_norm"]), pos


def _dec_enc_kv(cfg: ModelConfig, params, enc_out):
    """Per-decoder-layer cross K/V, stacked (L, B, T, KV, hd) each."""
    return _stack([encode_kv(cfg, lp, enc_out)
                   for lp in _unbind(params["blocks"])])


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _prepare_inputs(cfg: ModelConfig, params, batch):
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    x = embed_tokens(cfg, params, tokens)
    if cfg.vision_tokens:
        p = cfg.vision_tokens
        vis = batch["vision_embeds"].to(x.dtype)  # (B, P, D)
        mask = (torch.arange(s, device=dev) < p)[None, :, None]
        vis_full = F.pad(vis, (0, 0, 0, s - p))
        x = torch.where(mask, vis_full, x)
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
        b, s)
    if cfg.encoder_decoder:
        n_pos = params["dec_pos"].shape[0]
        x = x + params["dec_pos"][torch.arange(s, device=dev) % n_pos][None]
    return x, positions


def forward(cfg: ModelConfig, params, batch, *, collect_kv=False):
    """Full-sequence pass. Returns (logits, kv_stacks | None, aux)."""
    x, positions = _prepare_inputs(cfg, params, batch)
    if cfg.block == "hybrid":
        x, kv, aux = _hybrid_blocks(cfg, params, x, positions,
                                    collect_kv=collect_kv)
    elif cfg.block == "attn_moe" and cfg.moe_every == 2:
        x, kv, aux = _alt_blocks(cfg, params, x, positions,
                                 collect_kv=collect_kv)
    else:
        layers = _unbind(params["blocks"])
        enc_kv = enc_pos = None
        if cfg.encoder_decoder:
            enc_out, enc_pos = run_encoder(cfg, params, batch["frames"])
            enc_kv = [encode_kv(cfg, lp, enc_out) for lp in layers]
        x, kv, aux = _scan_blocks(cfg, layers, x, positions,
                                  enc_kv=enc_kv, enc_pos=enc_pos,
                                  lsh_proj=params.get("lsh_proj"),
                                  collect_kv=collect_kv)
    logits = lm_logits(cfg, params, x)
    return logits, kv, aux


def loss_fn(cfg: ModelConfig, params, batch):
    """Next-token CE (labels < 0 are masked) + MoE aux loss."""
    logits, _, aux = forward(cfg, params, batch)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      torch.clamp(labels, min=0)[..., None].long())[..., 0]
    ce = (logz - ll) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = ce.sum() / denom
    total = loss + 0.01 * aux
    return total, {"ce": loss, "aux": aux, "tokens": denom}


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    pos: torch.Tensor          # (W,) int32 positions of cache slots, -1 empty
    layers: Any                # stacked per-layer caches (see init_cache)
    shared: Any = None         # hybrid: (G, ...) KVCache for the shared block
    enc_kv: Any = None         # enc-dec: (L, B, T, KV, hd) cross K/V
    enc_pos: Any = None        # (B, T) encoder positions


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> DecodeCache:
    dev = resolve_device(device)
    dt = torch_dtype(cfg)
    kv, hd = cfg.n_kv_heads, cfg.hd
    w = cache_window(cfg, max_len)
    n = cfg.n_layers
    pos = torch.full((w,), -1, dtype=torch.int32, device=dev)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv_stack(lead, width):
        return KVCache(k=zeros(lead + (batch, width, kv, hd)),
                       v=zeros(lead + (batch, width, kv, hd)))

    shared = None
    if cfg.block in ("ssm", "hybrid"):
        per = init_ssm_cache(cfg, batch, device=dev)
        lead = (n,)
        if cfg.block == "hybrid":
            g = cfg.n_layers // cfg.shared_attn_period
            lead = (g, cfg.shared_attn_period)
            shared = kv_stack((g,), w)
        layers = SSMCache(*(zeros(lead + a.shape, a.dtype) for a in per))
    elif cfg.lsh_attention:
        layers = LSHKVCache(k=zeros((n, batch, w, kv, hd)),
                            v=zeros((n, batch, w, kv, hd)),
                            codes=zeros((n, batch, w, kv), torch.int32))
    else:
        layers = kv_stack((n,), w)

    enc_kv = enc_pos = None
    if cfg.encoder_decoder:
        t = cfg.encoder_seq
        enc_kv = (zeros((n, batch, t, kv, hd)), zeros((n, batch, t, kv, hd)))
        enc_pos = zeros((batch, t), torch.int32)
    return DecodeCache(pos=pos, layers=layers, shared=shared,
                       enc_kv=enc_kv, enc_pos=enc_pos)


def cache_axes(cfg: ModelConfig) -> DecodeCache:
    """Logical sharding axes matching init_cache's structure."""
    kvc = KVCache(k=(None, "batch", "kv_seq", "kv_heads", None),
                  v=(None, "batch", "kv_seq", "kv_heads", None))
    shared = None
    if cfg.block in ("ssm", "hybrid"):
        layers = SSMCache(
            state=(None, "batch", "ssm_heads", None, None),
            conv=(None, "batch", None, "ssm_inner"))
        if cfg.block == "hybrid":
            layers = SSMCache(state=(None,) + layers.state,
                              conv=(None,) + layers.conv)
            shared = kvc
    elif cfg.lsh_attention:
        layers = LSHKVCache(k=kvc.k, v=kvc.v,
                            codes=(None, "batch", "kv_seq", "kv_heads"))
    else:
        layers = kvc
    enc_kv = enc_pos = None
    if cfg.encoder_decoder:
        enc_kv = ((None, "batch", "frames", "kv_heads", None),) * 2
        enc_pos = ("batch", "frames")
    return DecodeCache(pos=(None,), layers=layers, shared=shared,
                       enc_kv=enc_kv, enc_pos=enc_pos)


# ---------------------------------------------------------------------------
# Prefill & decode
# ---------------------------------------------------------------------------


def _ring_place(stack: torch.Tensor, s: int, width: int) -> torch.Tensor:
    """Last `width` positions of (L,B,S,...) -> ring-aligned (L,B,W,...):
    slot = pos % width over the trailing positions is a rotation, so pad
    and roll."""
    take = min(s, width)
    vals = stack[:, :, s - take:]
    if take < width:
        pad = [0, 0] * (vals.ndim - 3) + [0, width - take]
        vals = F.pad(vals, pad)
    return torch.roll(vals, (s - take) % width, dims=2)


def prefill(cfg: ModelConfig, params, batch, max_len: int):
    """Run the full prompt, return (last-position logits, filled cache) on
    the params' device."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    logits, kv, _ = forward(cfg, params, batch, collect_kv=True)
    dev = params["final_norm"].device
    w = cache_window(cfg, max_len)

    def fill_kv(new: KVCache) -> KVCache:
        return KVCache(k=_ring_place(new.k, s, w), v=_ring_place(new.v, s, w))

    shared = None
    if cfg.block in ("ssm", "hybrid"):
        m_kv, s_kv = (kv if cfg.block == "hybrid" else (kv, None))
        layers = m_kv  # SSMCache stacks: final states from prefill
        if cfg.block == "hybrid":
            shared = fill_kv(s_kv)
    elif cfg.lsh_attention:
        layers = LSHKVCache(k=_ring_place(kv.k, s, w),
                            v=_ring_place(kv.v, s, w),
                            codes=_ring_place(kv.codes, s, w))
    else:
        layers = fill_kv(kv)
    del kv

    take = min(s, w)
    pos_arr = torch.full((w,), -1, dtype=torch.int32, device=dev)
    pos_arr[torch.arange(s - take, s, device=dev) % w] = torch.arange(
        s - take, s, dtype=torch.int32, device=dev)
    enc_kv = enc_pos = None
    if cfg.encoder_decoder:
        enc_out, enc_pos = run_encoder(cfg, params, batch["frames"])
        enc_kv = _dec_enc_kv(cfg, params, enc_out)
    cache = DecodeCache(pos=pos_arr, layers=layers, shared=shared,
                        enc_kv=enc_kv, enc_pos=enc_pos)
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params, token, cache: DecodeCache,
                cur_pos: int):
    """One decode step. token (B, 1) int; cur_pos a Python int.
    Returns (logits (B, V), the cache, updated in place: the slot of
    cur_pos is marked first, and every layer writes its K/V there before
    attending)."""
    b = token.shape[0]
    cur_pos = int(cur_pos)
    cache.pos[cur_pos % cache.pos.shape[0]] = cur_pos
    x = embed_tokens(cfg, params, token)
    if cfg.encoder_decoder:
        n_pos = params["dec_pos"].shape[0]
        x = x + params["dec_pos"][cur_pos % n_pos][None, None]
    positions = torch.full((b, 1), cur_pos, dtype=torch.int32,
                           device=x.device)

    if cfg.block == "hybrid":
        period = cfg.shared_attn_period
        groups = cfg.n_layers // period
        blocks = _reshape_lead(params["blocks"], (groups, period))
        shared = params["shared"]
        for gi in range(groups):
            gblocks, gm = _index(blocks, gi), _index(cache.layers, gi)
            for li in range(period):
                x, nc, _ = decoder_layer(cfg, _index(gblocks, li), x,
                                         positions,
                                         layer_cache=_index(gm, li),
                                         cur_pos=cur_pos)
                _store(gm, li, nc)
            delta, _ = attention_block(
                cfg, shared, x, positions, causal=True,
                window=cfg.sliding_window, cache=_index(cache.shared, gi),
                cache_pos=cache.pos, cur_pos=cur_pos)
            x = x + delta + mlp(cfg, shared, x + delta)
    elif cfg.block == "attn_moe" and cfg.moe_every == 2:
        dense_cfg = _dense_view(cfg)
        for i in range(cfg.n_layers // 2):
            for j, (c, lp) in enumerate(((dense_cfg, params["dense_blocks"]),
                                         (cfg, params["blocks"]))):
                li = 2 * i + j
                x, nc, _ = decoder_layer(c, _index(lp, i), x, positions,
                                         layer_cache=_index(cache.layers, li),
                                         cache_pos=cache.pos,
                                         cur_pos=cur_pos)
                _store(cache.layers, li, nc)
    else:
        lsh_proj = params.get("lsh_proj")
        for i in range(cfg.n_layers):
            x, nc, _ = decoder_layer(
                cfg, _index(params["blocks"], i), x, positions,
                layer_cache=_index(cache.layers, i), cache_pos=cache.pos,
                cur_pos=cur_pos, enc_kv=_index(cache.enc_kv, i),
                enc_pos=cache.enc_pos, lsh_proj=lsh_proj)
            _store(cache.layers, i, nc)

    return lm_logits(cfg, params, x)[:, 0], cache


# ---------------------------------------------------------------------------
# The params tree as a module
# ---------------------------------------------------------------------------


class _Tree(torch.nn.Module):
    """One level of a params tree: sub-dicts as child modules, leaves as
    parameters (taking gradients if ``trainable``)."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Tree(v, trainable))
            else:
                self.register_parameter(
                    k, torch.nn.Parameter(v, requires_grad=trainable))

    def tree(self) -> dict:
        out = {k: m.tree() for k, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


class LM(torch.nn.Module):
    """A model config and its params tree as one module (the engine's
    model): ``tree()`` gives the tree back with the reference's nesting,
    ``.to()`` moves it, and ``forward(batch)`` gives the logits. With
    ``trainable=True`` its leaves take gradients (``loss(batch)`` then
    ``backward()``); the engine serves it under ``inference_mode``
    either way."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.params = _Tree(params, trainable)

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, batch) -> torch.Tensor:
        return forward(self.cfg, self.tree(), batch)[0]

    def loss(self, batch):
        """``loss_fn`` on the module's tree: (loss, metrics)."""
        return loss_fn(self.cfg, self.tree(), batch)
