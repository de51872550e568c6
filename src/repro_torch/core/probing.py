"""Query-directed multi-probe key expansion (reference:
``repro.core.probing``).

Each (query, table) cell widens from its one bucket key to the T keys most
likely to hold near neighbours, without re-hashing: the bucket key is
linear in the codes (key = sum_k codes[k] * mults[k] mod 2^32), so moving
code k by +1 / -1 moves the key by +mults[k] / -mults[k] mod 2^32.

  * E2LSH ranks the floor residual r = t - floor(t), t = (v + b) / w:
    code k + 1 scores (1 - r_k)^2, code k - 1 scores r_k^2;
  * SRP ranks the margin |v_k|: flipping bit k scores |v_k|;

then every pair of singles on distinct coordinates scores the sum of its
two. One stable ascending top-(T-1) over the static candidate order
(singles, then pairs in ``_pair_indices`` order; ties to the lower index)
picks the probes. Slot 0 is the base key, and slots past the expansion
size repeat it.

uint32 deltas live in int64 in [0, 2^32), masked after every wrap.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels.epilogues import U32_MASK, div_w

QUERY_MODES = ("topk", "uniform", "weighted")


def _is_e2lsh(kind: str) -> bool:
    return kind.endswith("e2lsh")


def expansion_size(kind: str, num_codes: int) -> int:
    """Candidates the expansion ranks (the base bucket excluded): 2K singles
    + 2K(K-1) distinct-coordinate pairs for E2LSH, K + C(K, 2) for SRP."""
    k = num_codes
    if _is_e2lsh(kind):
        return 2 * k * k
    return k + k * (k - 1) // 2


def _pair_indices(coord: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Static (a, b) index pairs over the single-perturbation axis: every
    a < b whose perturbations touch distinct code coordinates."""
    n = coord.size
    pa, pb = np.triu_indices(n, k=1)
    keep = coord[pa] != coord[pb]
    return pa[keep], pb[keep]


@functools.lru_cache(maxsize=None)
def pair_indices(e2: bool, num_codes: int) -> tuple[np.ndarray, np.ndarray]:
    """``_pair_indices`` over the single axis of an E2LSH (2K singles, two
    per coordinate) or SRP (K singles) expansion."""
    k = np.arange(num_codes)
    return _pair_indices(np.concatenate([k, k]) if e2 else k)


def _scores_and_deltas(e2: bool, mults: torch.Tensor, aux: torch.Tensor):
    """(aux (B, L, K)) -> (scores (B, L, C) float32, deltas (B, L, C) uint32
    values in int64) in the static candidate order."""
    mults = mults.to(aux.device, torch.int64)
    neg = (0 - mults) & U32_MASK
    if e2:
        up = 1.0 - aux
        s1 = torch.cat([up * up, aux * aux], dim=-1)          # (B, L, 2K)
        d1 = torch.cat([mults, neg]).expand(s1.shape)
    else:
        s1 = aux.abs()
        d1 = torch.where(aux > 0, neg, mults)
    pa, pb = (torch.from_numpy(i).to(aux.device)
              for i in pair_indices(e2, mults.shape[0]))
    scores = torch.cat([s1, s1[..., pa] + s1[..., pb]], dim=-1)
    deltas = torch.cat([d1, (d1[..., pa] + d1[..., pb]) & U32_MASK], dim=-1)
    return scores, deltas


def scores_and_deltas(family, mults, aux):
    """Perturbation candidates of a hashed batch (``aux`` from
    ``family.hash_batch_aux``) -> (scores (B, L, C) float32, lower probes
    earlier; deltas (B, L, C) uint32 key shifts in int64)."""
    from repro_torch.kernels.ops import mults_tensor
    return _scores_and_deltas(_is_e2lsh(family.kind),
                              mults_tensor(mults, aux.device), aux)


def expand_keys(base: torch.Tensor, aux: torch.Tensor, mults: torch.Tensor,
                *, e2: bool, probes: int) -> torch.Tensor:
    """(base (B, L) keys, aux (B, L, K)) -> (B, L, T) ranked keys: slot 0
    the base key, then the stable top-(T-1) perturbations, then the base key
    again past the expansion size."""
    t = int(probes)
    if t == 1:
        return base[..., None]
    scores, deltas = _scores_and_deltas(e2, mults, aux)
    n = min(t - 1, scores.shape[-1])
    order = torch.argsort(scores, dim=-1, stable=True)[..., :n]
    keys = (base[..., None] + torch.gather(deltas, -1, order)) & U32_MASK
    pad = base[..., None].expand(base.shape + (t - 1 - n,))
    return torch.cat([base[..., None], keys, pad], dim=-1)


def discretize_aux(values, offsets, *, e2: bool, w: float, num_tables: int,
                   num_codes: int):
    """(B, L*K) raw values -> (codes (B, L, K) int32, aux (B, L, K)): the
    floor residual of t = (v + b) / w (E2LSH) or the value itself (SRP), as
    the reference's kernel computes them."""
    b = values.shape[0]
    if e2:
        t = div_w(values + offsets, w)
        codes = torch.floor(t).to(torch.int32)
        aux = t - codes.to(values.dtype)
    else:
        codes = (values > 0).to(torch.int32)
        aux = values
    return (codes.reshape(b, num_tables, num_codes),
            aux.reshape(b, num_tables, num_codes))


def probe_keys(family, mults, queries, *, probes: int) -> torch.Tensor:
    """-> (B, L, T) ranked candidate bucket keys (uint32 values in int64).
    Slot 0 is the base key (``hash_keys``' value on the plain projection
    path), then the top-(T-1) perturbations; one hash of the batch."""
    from repro_torch.core.lsh import _combine_codes
    from repro_torch.kernels.ops import mults_tensor

    t = int(probes)
    if t < 1:
        raise ValueError(f"probes must be >= 1, got {probes}")
    mults = mults_tensor(mults, family.device)
    codes, aux = family.hash_batch_aux(queries)
    base = _combine_codes(codes, mults)                   # (B, L)
    return expand_keys(base, aux, mults, e2=_is_e2lsh(family.kind), probes=t)
