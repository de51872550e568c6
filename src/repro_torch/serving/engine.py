"""Serving engine: prefill / decode step factories + a batched generation
loop (reference: ``repro.serving.engine``).

The steps run under ``torch.inference_mode()`` (no autograd) on the
device the params live on; training takes its gradients in
``training.train_loop``, never here. ``params`` is a params tree (a
trained ``TrainState.params`` too) or a ``models.transformer.LM``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def _tree(params) -> dict:
    return params.tree() if isinstance(params, T.LM) else params


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """prefill_step(params, batch) -> (last_logits (B, V), DecodeCache)."""
    def prefill_step(params, batch):
        with torch.inference_mode():
            return T.prefill(cfg, _tree(params), batch, max_len=max_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, token, cur_pos) -> (logits, cache).
    One new token against the cache, written in place."""
    def serve_step(params, cache, token, cur_pos: int):
        with torch.inference_mode():
            return T.decode_step(cfg, _tree(params), token, cache, cur_pos)
    return serve_step


def mask_pad(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Padded vocab ids (past ``vocab_size``) set to -inf: never chosen."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    ids = torch.arange(cfg.padded_vocab, device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits, float("-inf"))


def greedy_generate(cfg: ModelConfig, params, batch, *, steps: int,
                    max_len: int, temperature: float = 0.0,
                    generator: torch.Generator | None = None
                    ) -> torch.Tensor:
    """Prefill the prompt, then ``steps`` tokens (B, steps) int32: the
    first the ``argmax`` (the first maximum) of the prefill's last logits,
    each next from a decode step over the token before, by ``argmax``
    unless ``temperature > 0`` and a ``generator`` (on the params' device)
    is given, which then draws from softmax(logits / temperature). Every
    decode position stays below ``max_len``."""
    s = batch["tokens"].shape[1]
    if s + steps - 1 > max_len:
        raise ValueError(f"a {s}-token prompt and {steps} steps need "
                         f"{s + steps - 1} cache slots; max_len is {max_len}")
    prefill_step = make_prefill_step(cfg, max_len)
    serve = make_serve_step(cfg)

    def pick(logits, sample: bool):
        logits = mask_pad(cfg, logits)
        if sample and temperature > 0.0 and generator is not None:
            p = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(p, 1, generator=generator).to(
                torch.int32)
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)

    last, cache = prefill_step(params, batch)
    tok = pick(last, False)
    out = [tok]
    cur = s
    for _ in range(steps - 1):
        logits, cache = serve(params, cache, tok, cur)
        tok = pick(logits, True)
        out.append(tok)
        cur += 1
    return torch.cat(out, dim=1)
