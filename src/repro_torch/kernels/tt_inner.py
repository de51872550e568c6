"""K4: batch-native fused TT x TT hashing, the transfer-matrix chain
(reference: ``repro.kernels.tt_inner.tt_inner_pallas``).

For a batch of TT inputs X_z and L*K stacked TT projections T_{l,k}, both
in the padded layout of ``ops`` (boundary ranks zero-padded to R, mode dims
to one d; zero entries add exact zeros to every chain step):

    S <- e_00;  S <- sum_i Gx[:, i, :]^T S Gp[:, i, :]  for each mode;
    v[z, l, k] = scale * S[0, 0]

followed by the epilogue (``epilogues.apply_epilogue``). ``tt_inner``
launches the CUDA kernel ``csrc/tt_inner.cu`` on CUDA tensors and runs the
plain version ``tt_inner_plain`` on CPU tensors; any other device raises.
``tt_inner.launches`` counts kernel launches, ``tt_inner_plain.calls``
calls of the plain version.

``plan`` picks the launch: ranks up to ``MAX_THREAD_RANK`` run the thread
kernel (the chain state of a register tile of items x hashes a thread,
tiles ``THREAD_TILES`` by padded rank, cores staged ``SLICES`` slices at a
time) on blocks of items x flattened hashes sized from the launch's shape
and the card's SM count; ranks up to ``MAX_RANK`` run the warp kernel (one
warp per (item, hash), the state spread over its lanes). Above
``MAX_RANK`` the wrapper raises. The C launch recomputes a plan's threads
and shared bytes and refuses one that differs, so these copies of its
shapes cannot drift.
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
MAX_RANK = 16             # largest Rx, Rp of the warp kernel (RWARP)
SLICES = 8                # slices of a mode a thread-kernel stage holds
WARP_SLICES = 4           # slices of a mode a warp-kernel stage holds
# the thread kernel's padded ranks: their register tiles (items, hashes a
# thread) and largest blocks in threads (Tile<R> in the source)
THREAD_TILES = {4: (2, 1), 8: (1, 1)}
MAX_THREADS = {4: 256, 8: 128}


def tt_inner_plain(x_cores: torch.Tensor, p_cores: torch.Tensor,
                   offsets: torch.Tensor | None = None,
                   mults: torch.Tensor | None = None, *,
                   epilogue: str = "raw", w: float = 1.0,
                   scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K4: x_cores (B, N, Rx, d, Rx), p_cores
    (N, L, K, Rp, d, Rp) -> the epilogue's output (see ``out_struct``).
    The chain runs one slice i of the mode dim at a time, so its
    intermediates stay at the (B, L*K, R, R) state's size."""
    tt_inner_plain.calls += 1
    b, n, rx, d, _ = x_cores.shape
    _, l, k, rp, _, _ = p_cores.shape
    p = p_cores.reshape(n, l * k, rp, d, rp)
    s = torch.zeros((b, l * k, rx, rp), dtype=torch.float32,
                    device=x_cores.device)
    s[:, :, 0, 0] = 1.0
    for m in range(n):
        s_new = torch.zeros_like(s)
        for i in range(d):
            u = torch.einsum("ztab,zac->ztbc", s, x_cores[:, m, :, i, :])
            s_new += torch.einsum("ztbc,tbe->ztce", u, p[m, :, :, i, :])
        s = s_new
    v = (scale * s[:, :, 0, 0]).reshape(b, l, k)
    return apply_epilogue(v, offsets, mults, epilogue=epilogue, w=w)


tt_inner_plain.calls = 0


def padded_rank(rx: int, rp: int) -> int | None:
    """The thread kernel's padded rank for these ranks (``rank_of`` in the
    source), or None: the warp kernel."""
    r = max(rx, rp)
    return 4 if r <= 4 else MAX_THREAD_RANK if r <= MAX_THREAD_RANK else None


def thread_smem(r: int, d: int, bi: int, bh: int) -> int:
    """Shared bytes of a thread-kernel block (``thread_smem`` in the
    source): 128 bytes of mbarriers, then two stages of its items' and
    hashes' core rows (r rows x min(d, SLICES) slices of r floats each),
    or the block's values if larger."""
    return 128 + max(2 * r * min(d, SLICES) * (bi + bh) * r * 4, bi * bh * 4)


def warp_smem(wb: int) -> int:
    """Shared bytes of a warp-kernel block of ``wb`` warps: two stages of
    the item's and the hashes' slice chunks, each warp's S and T, the
    block's values."""
    r = MAX_RANK
    return (2 * (1 + wb) * WARP_SLICES * r * r + wb * 2 * r * r + wb) * 4


@functools.lru_cache(maxsize=None)
def plan(b: int, num_tables: int, k: int, rx: int, rp: int, d: int,
         sms: int) -> Plan:
    """K4's launch for ``b`` items (B, N, Rx, d, Rx) and ``num_tables`` x
    ``k`` hashes (Rp) on a card of ``sms`` SMs: the thread kernel's block
    up to ``MAX_THREAD_RANK`` (``epilogues.thread_plan``; its slice chunks
    fit any d), else the warp kernel's (``epilogues.warp_plan``)."""
    r = padded_rank(rx, rp)
    if r is None:
        return warp_plan(b, num_tables * k, sms, warp_smem)
    return thread_plan(b, num_tables * k, sms, THREAD_TILES[r],
                       MAX_THREADS[r], functools.partial(thread_smem, r, d))


def occupancy(p: Plan, d: int, rx: int, rp: int) -> dict:
    """What the card makes of the kernel a plan runs: registers a thread,
    resident blocks per SM and local (spilled) bytes a thread."""
    import ctypes

    from repro_torch.kernels import _build

    out = (ctypes.c_int * 3)()
    _build.check(_build.lib().tt_inner_occupancy(
        d, rx, rp, p.block_items, p.block_hashes, ctypes.addressof(out)),
        "tt_inner_occupancy")
    return dict(registers=out[0], blocks_per_sm=out[1], local_bytes=out[2])


def tt_inner(x_cores: torch.Tensor, p_cores: torch.Tensor,
             offsets: torch.Tensor | None = None,
             mults: torch.Tensor | None = None, *, epilogue: str = "raw",
             w: float = 1.0, scale: float = 1.0) -> torch.Tensor:
    """K4 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    dev = x_cores.device
    if dev.type == "cpu":
        return tt_inner_plain(x_cores, p_cores, offsets, mults,
                              epilogue=epilogue, w=w, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"tt_inner runs on cuda or cpu tensors, got {dev}")
    from repro_torch.kernels import _build

    b, n, rx, d, rx2 = x_cores.shape
    n2, l, k, rp, d2, rp2 = p_cores.shape
    if (n2, d2) != (n, d) or rx2 != rx or rp2 != rp:
        raise ValueError(f"x {tuple(x_cores.shape)} and p "
                         f"{tuple(p_cores.shape)} are not (B, N, Rx, d, Rx) "
                         "and (N, L, K, Rp, d, Rp) layouts of one (N, d)")
    if epilogue.startswith("e2lsh") and offsets is None:
        raise ValueError(f"epilogue {epilogue!r} needs offsets")
    if epilogue.endswith("keys") and mults is None:
        raise ValueError(f"epilogue {epilogue!r} needs mults")
    x = x_cores.contiguous().float()
    p = p_cores.contiguous().float()
    offs = (offsets.reshape(l, k).contiguous().float().to(dev)
            if offsets is not None else None)
    mu = (mults.reshape(k).to(dev, torch.int64).contiguous()
          if mults is not None else None)
    if max(rx, rp) > MAX_RANK:
        raise ValueError(f"K4 takes ranks up to {MAX_RANK}; got Rx={rx}, "
                         f"Rp={rp}")
    lp = plan(b, l, k, rx, rp, d, sm_count(dev))
    shape, dtype = out_struct(b, l, k, epilogue)
    # hash blocks that cut a table add their keys and words into zeros
    out = (torch.zeros if needs_zeros(lp, l, k, epilogue) else torch.empty)(
        shape, dtype=dtype, device=dev)
    if b == 0:
        return out
    with torch.cuda.device(dev):   # the launch goes to the tensors' card
        err = _build.lib().tt_inner_launch(
            x.data_ptr(), p.data_ptr(),
            offs.data_ptr() if offs is not None else None,
            mu.data_ptr() if mu is not None else None,
            out.data_ptr(), b, n, d, rx, l, k, rp, _EPILOGUE_CODE[epilogue],
            float(w), float(scale), lp.block_items, lp.block_hashes,
            lp.threads, lp.smem, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "tt_inner_launch")
    count_launch(tt_inner)
    return out


counted(tt_inner)
