"""K3: batch-native fused CP x CP hashing (reference:
``repro.kernels.cp_gram.cp_gram_pallas``).

For a batch of CP inputs X_z and L*K stacked CP projections P_{l,k} (mode
dims zero-padded to one d by ``ops``; zero rows add exact zeros to a Gram):

    v[z, l, k] = scale * sum_{r,q} prod_n (X_{z,n}^T P_{(l,k),n})[r, q]

followed by the epilogue (``epilogues.apply_epilogue``). ``cp_gram``
launches the CUDA kernel ``csrc/cp_gram.cu`` on CUDA tensors and runs the
plain version ``cp_gram_plain`` on CPU tensors; any other device raises.
``cp_gram.launches`` counts kernel launches, ``cp_gram_plain.calls`` calls
of the plain version.

Ranks up to ``MAX_THREAD_RANK`` run one thread per (item, table) over
register tiles, with a table's hashes tiled over blocks where its factors
do not fit ``SMEM_BUDGET`` beside the items (``block_items``); ranks up to
``MAX_RANK``, and shapes of which not even one item and one hash fit the
budget, run the warp kernel (one warp per (item, table), nothing staged).
Above ``MAX_RANK`` the wrapper raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.epilogues import EPILOGUES, apply_epilogue, out_struct

_EPILOGUE_CODE = {name: i for i, name in enumerate(EPILOGUES)}
SMEM_BUDGET = 96 * 1024   # bytes of shared memory a K3 block may take
MAX_THREAD_RANK = 8       # largest Rx, Rp the per-thread register tiles hold
MAX_RANK = 32             # largest Rx, Rp of the warp kernel


def cp_gram_plain(x_factors: torch.Tensor, p_factors: torch.Tensor,
                  offsets: torch.Tensor | None = None,
                  mults: torch.Tensor | None = None, *,
                  epilogue: str = "raw", w: float = 1.0,
                  scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K3: x_factors (B, N, d, Rx), p_factors
    (N, L, K, d, Rp) -> the epilogue's output (see ``out_struct``)."""
    cp_gram_plain.calls += 1
    b, n, d, rx = x_factors.shape
    _, l, k, _, rp = p_factors.shape
    h = None
    for m in range(n):
        g = torch.einsum("zdr,tdq->ztrq", x_factors[:, m],
                         p_factors[m].reshape(l * k, d, rp))
        h = g if h is None else h * g
    v = (scale * h.sum(dim=(2, 3))).reshape(b, l, k)
    return apply_epilogue(v, offsets, mults, epilogue=epilogue, w=w)


cp_gram_plain.calls = 0


def block_items(n_modes: int, d: int, rx: int, num_tables: int, k: int,
                rp: int, b: int) -> tuple[int, int, int] | None:
    """(items, tables, hashes) per block of K3's thread kernel: up to 64
    items (never more than the batch needs) and as many whole tables as fit
    1024 threads and ``SMEM_BUDGET`` bytes of staged factors; where one
    table does not fit beside the items, one table's hashes in chunks of
    as many as fit (a multiple of 32 where that is at least 32, so packed
    words stay whole), with fewer items where 32 hashes, or one, do not.
    None where not even one item and one hash fit: the warp kernel then
    serves the shape."""
    per_item = n_modes * d * rx * 4
    per_hash = n_modes * d * rp * 4

    def fits(bb, lb, kb):
        return bb * per_item + lb * kb * per_hash <= SMEM_BUDGET

    bb = min(64, -(-b // 32) * 32)
    lb = max(1, min(num_tables, 1024 // bb))
    while lb > 1 and not fits(bb, lb, k):
        lb -= 1
    if fits(bb, lb, k):
        return bb, lb, k
    for least in (min(k, 32), 1):
        items = bb
        while items > 1 and not fits(items, 1, least):
            items //= 2
        if fits(items, 1, least):
            break
    else:
        return None
    kb = min(k, (SMEM_BUDGET - items * per_item) // per_hash)
    if kb >= 32:
        kb -= kb % 32
    return items, 1, kb


def cp_gram(x_factors: torch.Tensor, p_factors: torch.Tensor,
            offsets: torch.Tensor | None = None,
            mults: torch.Tensor | None = None, *, epilogue: str = "raw",
            w: float = 1.0, scale: float = 1.0) -> torch.Tensor:
    """K3 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    dev = x_factors.device
    if dev.type == "cpu":
        return cp_gram_plain(x_factors, p_factors, offsets, mults,
                             epilogue=epilogue, w=w, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"cp_gram runs on cuda or cpu tensors, got {dev}")
    from repro_torch.kernels import _build

    b, n, d, rx = x_factors.shape
    n2, l, k, d2, rp = p_factors.shape
    if (n2, d2) != (n, d):
        raise ValueError(f"x {tuple(x_factors.shape)} and p "
                         f"{tuple(p_factors.shape)} disagree on (N, d)")
    if epilogue.startswith("e2lsh") and offsets is None:
        raise ValueError(f"epilogue {epilogue!r} needs offsets")
    if epilogue.endswith("keys") and mults is None:
        raise ValueError(f"epilogue {epilogue!r} needs mults")
    x = x_factors.contiguous().float()
    p = p_factors.contiguous().float()
    offs = (offsets.reshape(l, k).contiguous().float().to(dev)
            if offsets is not None else None)
    mu = (mults.reshape(k).to(dev, torch.int64).contiguous()
          if mults is not None else None)
    if max(rx, rp) > MAX_RANK:
        raise ValueError(f"K3 takes ranks up to {MAX_RANK}; got Rx={rx}, "
                         f"Rp={rp}")
    blocks = (block_items(n, d, rx, l, k, rp, b)
              if max(rx, rp) <= MAX_THREAD_RANK else None)
    bb, lb, kb = blocks or (0, 0, k)    # block_b 0: the warp kernel
    shape, dtype = out_struct(b, l, k, epilogue)
    # a table tiled over hashes adds its chunks' keys and words into zeros
    out = (torch.zeros if kb < k else torch.empty)(shape, dtype=dtype,
                                                   device=dev)
    if b == 0:
        return out
    err = _build.lib().cp_gram_launch(
        x.data_ptr(), p.data_ptr(),
        offs.data_ptr() if offs is not None else None,
        mu.data_ptr() if mu is not None else None,
        out.data_ptr(), b, n, d, rx, l, k, rp, _EPILOGUE_CODE[epilogue],
        float(w), float(scale), bb, lb, kb,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cp_gram_launch")
    cp_gram.launches += 1
    return out


cp_gram.launches = 0
