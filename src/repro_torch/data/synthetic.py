"""Deterministic synthetic data pipeline (reference:
``repro.data.synthetic``).

The stream is a *pure function of (seed, step)*: `batch_at(step)` draws
from a fresh generator seeded from both, so a restarted job resumes at step
N with bit-identical data, and the CPU and the card see the same batch
(the draws are made on the CPU, then moved to ``device``).

Sequences are learnable: tokens follow a fixed affine bigram rule
t_{k+1} = (a * t_k + c) mod V with a small noise probability, so next-token
CE drops far below ln(V) once the model learns the bigram function.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.params import torch_dtype


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 256
    seed: int = 0
    mult: int = 5      # bigram rule t' = (mult * t + add) % V
    add: int = 7
    noise_prob: float = 0.02


def bigram_next(dc: DataConfig, cfg: ModelConfig, tok):
    return (dc.mult * tok + dc.add) % cfg.vocab_size


def batch_at(dc: DataConfig, cfg: ModelConfig, step: int, device="cuda"):
    """-> {"tokens": (B, S) int32, "labels": (B, S) int32, [frontend stubs]}
    on ``device``."""
    dev = resolve_device(device)
    # a fresh CPU generator seeded from (seed, step) alone
    seed = np.random.SeedSequence([dc.seed, int(step)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(seed) & ((1 << 63) - 1))
    b, s = dc.batch_size, dc.seq_len
    vocab = cfg.vocab_size
    tokens = torch.empty((b, s), dtype=torch.int64)
    tokens[:, 0] = torch.randint(0, vocab, (b,), generator=gen)
    for j in range(1, s):
        tokens[:, j] = bigram_next(dc, cfg, tokens[:, j - 1])
    noise = torch.randint(0, vocab, (b, s), generator=gen)
    mask = torch.rand((b, s), generator=gen) < dc.noise_prob
    tokens = torch.where(mask, noise, tokens).to(torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    dtype = torch_dtype(cfg)
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.randn(
            (b, cfg.vision_tokens, cfg.d_model), generator=gen).to(dtype)
        labels[:, :cfg.vision_tokens] = -1
    if cfg.encoder_decoder:
        batch["frames"] = torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), generator=gen).to(dtype)
    return {k: v.to(dev) for k, v in batch.items()}
