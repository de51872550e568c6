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

``plan`` picks the launch: ranks up to ``MAX_THREAD_RANK`` run the thread
kernel (a register tile of items x hashes a thread, instantiations
``THREAD_TILES``) on blocks of items x flattened hashes sized from the
launch's shape and the card's SM count; ranks up to ``MAX_RANK``, and
shapes of which the thread kernel cannot stage one block, run the warp
kernel (one warp per (item, hash)). Above ``MAX_RANK`` the wrapper raises.
The C launch recomputes a plan's threads and shared bytes and refuses one
that differs, so these copies of its shapes cannot drift.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.counts import count_launch, counted
from repro_torch.kernels.epilogues import (EPILOGUES, Plan, apply_epilogue,
                                           needs_zeros, out_struct, sm_count,
                                           thread_plan, warp_plan)

_EPILOGUE_CODE = {name: i for i, name in enumerate(EPILOGUES)}
MAX_THREAD_RANK = 8       # largest Rx, Rp of the thread kernel
MAX_RANK = 32             # largest Rx, Rp of the warp kernel
MAX_THREADS = 128         # threads of a thread-kernel block (kThreadMax)
WARP_CHUNK = 2048         # floats of a warp's staged rows (kWarpChunk)
# the thread kernel's instantiations (compile-time Rx, Rp) and their
# register tiles (items, hashes a thread): the serving shape exactly, then
# ranks padded to 4 and to 8
THREAD_TILES = {(4, 3): (2, 2), (4, 4): (2, 2), (8, 8): (1, 1)}


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


def instantiation(rx: int, rp: int) -> tuple[int, int] | None:
    """The thread kernel's compile-time (Rx, Rp) for these ranks (``inst_of``
    in the source), or None: the warp kernel."""
    if (rx, rp) == (4, 3):
        return 4, 3
    if max(rx, rp) <= 4:
        return 4, 4
    if max(rx, rp) <= MAX_THREAD_RANK:
        return 8, 8
    return None


def thread_smem(n_modes: int, d: int, inst: tuple[int, int], bi: int,
                bh: int) -> int:
    """Shared bytes of a thread-kernel block (``thread_smem`` in the
    source): every mode row of its items and hashes in float4 units at slot
    strides bi + 1 and bh + 1, or the block's values if larger."""
    qx, qp = (-(-r // 4) for r in inst)
    return max(n_modes * d * (qx * (bi + 1) + qp * (bh + 1)) * 16,
               bi * bh * 4)


def warp_smem(wb: int) -> int:
    """Shared bytes of a warp-kernel block of ``wb`` warps."""
    return (wb * WARP_CHUNK + wb) * 4


@functools.lru_cache(maxsize=None)
def plan(b: int, num_tables: int, k: int, rx: int, rp: int, n_modes: int,
         d: int, sms: int) -> Plan:
    """K3's launch for ``b`` items (B, N, d, Rx) and ``num_tables`` x ``k``
    hashes (Rp) on a card of ``sms`` SMs: the thread kernel's block where
    its instantiation stages one (``epilogues.thread_plan``), else the warp
    kernel's (``epilogues.warp_plan``)."""
    inst = instantiation(rx, rp)
    if inst is not None:
        p = thread_plan(b, num_tables * k, sms, THREAD_TILES[inst],
                        MAX_THREADS,
                        functools.partial(thread_smem, n_modes, d, inst))
        if p is not None:
            return p
    return warp_plan(b, num_tables * k, sms, warp_smem)


def occupancy(p: Plan, n_modes: int, d: int, rx: int, rp: int) -> dict:
    """What the card makes of the kernel a plan runs: registers a thread,
    resident blocks per SM and local (spilled) bytes a thread."""
    import ctypes

    from repro_torch.kernels import _build

    out = (ctypes.c_int * 3)()
    _build.check(_build.lib().cp_gram_occupancy(
        n_modes, d, rx, rp, p.block_items, p.block_hashes,
        ctypes.addressof(out)), "cp_gram_occupancy")
    return dict(registers=out[0], blocks_per_sm=out[1], local_bytes=out[2])


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
    lp = plan(b, l, k, rx, rp, n, d, sm_count(dev))
    shape, dtype = out_struct(b, l, k, epilogue)
    # hash blocks that cut a table add their keys and words into zeros
    out = (torch.zeros if needs_zeros(lp, l, k, epilogue) else torch.empty)(
        shape, dtype=dtype, device=dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):   # the launch goes to the tensors' card
        err = _build.lib().cp_gram_launch(
            x.data_ptr(), p.data_ptr(),
            offs.data_ptr() if offs is not None else None,
            mu.data_ptr() if mu is not None else None,
            out.data_ptr(), b, n, d, rx, l, k, rp, _EPILOGUE_CODE[epilogue],
            float(w), float(scale), lp.block_items, lp.block_hashes,
            lp.threads, lp.smem, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cp_gram_launch")
    count_launch(cp_gram)
    return out


counted(cp_gram)
