"""Gradient compression via the paper's tensorized random projection
(reference: ``repro.training.compression``).

Each gradient matrix G in R^{d1 x d2} is sketched with K fresh
CP-Rademacher projection tensors (Definitions 6 and 8): s_k = <P_k, G>
(Eq. 3.11). Every worker derives the same P_k from the shared (seed,
step, leaf), so only the K-vector s would cross the wire; the factors
take O(K (d1 + d2) R) numbers against O(K d1 d2) for a dense sketch.

Decompression is sketch-and-project: G^ = sum_k alpha_k P_k with
(M + ridge * trace(M) / K * I) alpha = s, M[k, l] = <P_k, P_l> by the
paper's CP x CP contraction (Hadamard of per-mode Grams). G - G^ is
kept as error feedback and added to the next step's gradient.

The reference draws the factors with ``jax.random`` (``fold_in(seed,
step, leaf)``, then ``bernoulli``); the port draws them with a
``torch.Generator`` on the gradient's device seeded from (seed, step,
leaf) alone, so two workers with the same triple draw the same factors.
The two packages' factors differ; ``roundtrip`` takes supplied factors
(``factors=``), which is how the tests carry the reference's across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_map


class CompressorState(NamedTuple):
    error: Any  # error-feedback accumulator, f32, like params


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    num_projections: int = 64   # K
    rank: int = 2               # R
    min_size: int = 65536       # leaves smaller than this are sent raw
    seed: int = 1234
    ridge: float = 1e-5


def _matricize_shape(shape) -> tuple[int, int] | None:
    if len(shape) < 2:
        return None
    return shape[0], math.prod(shape[1:])


def init_compressor(cfg: CompressionConfig, params):
    """Returns (sketch seed, state): the factors are re-derived per (step,
    leaf), never stored; the error starts at zero in float32."""
    err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    return int(cfg.seed), CompressorState(error=err)


def factor_generator(seed: int, step: int, leaf_idx: int,
                     device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step, leaf) alone."""
    s = np.random.SeedSequence([int(seed), int(step), int(leaf_idx)])
    word = int(s.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(word)


def _rademacher(gen: torch.Generator, shape, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.bernoulli_(0.5, generator=gen).mul_(2.0).sub_(1.0)


def _factors(cfg: CompressionConfig, seed, step, leaf_idx, d1, d2,
             device="cuda"):
    """(fa (K, d1, R), fb (K, d2, R)) float32 +-1, equiprobable."""
    gen = factor_generator(seed, step, leaf_idx, device)
    fa = _rademacher(gen, (cfg.num_projections, d1, cfg.rank), device)
    fb = _rademacher(gen, (cfg.num_projections, d2, cfg.rank), device)
    return fa, fb


def _sketch(g2, fa, fb, rank):
    # s_k = (1/sqrt(R)) sum_r a_{k,:,r}^T G b_{k,:,r}   (paper Eq. 3.11)
    t = torch.einsum("ij,kjr->kir", g2, fb)
    return torch.einsum("kir,kir->k", t, fa) / math.sqrt(rank)


def _projection_gram(fa, fb, rank):
    """M[k,l] = <P_k, P_l> via the paper's CP x CP contraction (Hadamard
    of per-mode Grams over the (k, l) pair grid)."""
    ga = torch.einsum("kir,lis->klrs", fa, fa)
    gb = torch.einsum("kjr,ljs->klrs", fb, fb)
    return torch.einsum("klrs,klrs->kl", ga, gb) / rank


def _solve(m, s, ridge):
    """alpha with (M + ridge * trace(M) / K * I) alpha = s."""
    k = m.shape[0]
    eye = torch.eye(k, dtype=m.dtype, device=m.device)
    return torch.linalg.solve(m + ridge * torch.trace(m) / k * eye, s)


def _expand(alpha, fa, fb, rank):
    """G^ = (1/sqrt(R)) sum_k alpha_k P_k."""
    return torch.einsum("k,kir,kjr->ij", alpha, fa, fb) / math.sqrt(rank)


def _project(s, fa, fb, rank, ridge):
    """Least-norm G^ with <P_k, G^> = s_k (sketch-and-project)."""
    return _expand(_solve(_projection_gram(fa, fb, rank), s, ridge), fa,
                   fb, rank)


def roundtrip(cfg: CompressionConfig, sketch_seed, state: CompressorState,
              grads, step=None,
              factors: Callable[[int, int, int], tuple] | None = None):
    """compress -> (where the data-parallel all-reduce of ``s`` would run)
    -> project back + error feedback. Returns (approx_grads, new_state,
    metrics {"comm_ratio"}). Leaves pair with their index in the
    reference's flatten order (sorted dict keys); ``factors(leaf_idx, d1,
    d2)`` -> (fa, fb), if given, supplies each compressed leaf's factors
    in place of the port's draw."""
    step = 0 if step is None else int(step)
    g_leaves = tree_leaves(grads)
    e_leaves = tree_leaves(state.error)
    out_g, out_e, ratios = {}, {}, []
    for i, ((path, g), (_, e)) in enumerate(zip(g_leaves, e_leaves)):
        ms = _matricize_shape(tuple(g.shape))
        if ms is None or g.numel() < cfg.min_size:
            out_g[path] = g
            out_e[path] = torch.zeros_like(e)
            continue
        d1, d2 = ms
        fa, fb = (factors(i, d1, d2) if factors is not None
                  else _factors(cfg, sketch_seed, step, i, d1, d2, g.device))
        gf = g.to(torch.float32) + e
        g2 = gf.reshape(d1, d2)
        s = _sketch(g2, fa, fb, cfg.rank)            # <- the only comm
        ghat = _project(s, fa, fb, cfg.rank, cfg.ridge).reshape(g.shape)
        out_g[path] = ghat.to(g.dtype)
        out_e[path] = gf - ghat
        ratios.append(s.numel() / g.numel())
    mean_ratio = (sum(ratios) / len(ratios)) if ratios else 1.0
    dev = g_leaves[0][1].device
    return (_unflatten_like(grads, out_g), CompressorState(
        error=_unflatten_like(state.error, out_e)),
        {"comm_ratio": torch.tensor(mean_ratio, dtype=torch.float32,
                                    device=dev)})


def _unflatten_like(tree, flat: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    return flat[prefix[:-1]]
