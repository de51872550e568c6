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

Ranks up to ``MAX_THREAD_RANK`` run one thread per (item, hash) with the
chain state in registers, a table of more than ``MAX_THREADS`` hashes tiled
over blocks (``block_shape``); ranks up to ``MAX_RANK``, and shapes whose
cores do not fit the staging budget, run one warp per (item, table), the
state in shared memory and nothing staged. Above ``MAX_RANK`` the wrapper
raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.epilogues import EPILOGUES, apply_epilogue, out_struct

_EPILOGUE_CODE = {name: i for i, name in enumerate(EPILOGUES)}
SMEM_BUDGET = 96 * 1024   # bytes of shared memory a K4 block may take
MAX_THREAD_RANK = 8       # largest Rx, Rp the per-thread register tiles hold
MAX_RANK = 16             # largest Rx, Rp of the warp kernel
MAX_THREADS = 512         # threads of a K4 block (MAX_THREADS in the source)


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


def block_shape(d: int, rx: int, rp: int, num_tables: int, k: int,
                b: int) -> tuple[int, int, int] | None:
    """(items, tables, hashes) per block of K4's thread kernel: one thread
    per (item, hash), up to 32 items (never more than the batch holds) and
    as many whole tables as fit ``MAX_THREADS`` threads and ``SMEM_BUDGET``
    bytes of one mode's staged cores; a table of more than ``MAX_THREADS``
    hashes runs one item and the table's hashes in chunks of as many as
    fit (a multiple of 32, so packed words stay whole). None where not
    even one item and one table (or 32 hashes of it) fit: the warp kernel
    then serves the shape."""
    kb = min(k, MAX_THREADS)
    bb = max(1, min(32 if 32 * kb <= MAX_THREADS else MAX_THREADS // kb, b))

    def smem(bb, lb, kb):
        stage = rx * d * rx * bb + lb * kb * rp * d * rp
        return 4 * max(stage, bb * lb * kb)

    lb = max(1, min(num_tables, MAX_THREADS // (bb * kb)))
    while lb > 1 and smem(bb, lb, kb) > SMEM_BUDGET:
        lb -= 1
    while bb > 1 and smem(bb, lb, kb) > SMEM_BUDGET:
        bb //= 2
    while kb > 32 and smem(bb, lb, kb) > SMEM_BUDGET:
        kb = (kb - 1) // 32 * 32   # lb is 1 here: the loops above end at 1
                                   # or fitting
    if smem(bb, lb, kb) > SMEM_BUDGET:
        return None
    return bb, lb, kb


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
    blocks = (block_shape(d, rx, rp, l, k, max(b, 1))
              if max(rx, rp) <= MAX_THREAD_RANK else None)
    bb, lb, kb = blocks or (0, 0, k)    # block_b 0: the warp kernel
    shape, dtype = out_struct(b, l, k, epilogue)
    # a table tiled over hashes adds its chunks' keys and words into zeros
    out = (torch.zeros if kb < k else torch.empty)(shape, dtype=dtype,
                                                   device=dev)
    if b == 0:
        return out
    err = _build.lib().tt_inner_launch(
        x.data_ptr(), p.data_ptr(),
        offs.data_ptr() if offs is not None else None,
        mu.data_ptr() if mu is not None else None,
        out.data_ptr(), b, n, d, rx, l, k, rp, _EPILOGUE_CODE[epilogue],
        float(w), float(scale), bb, lb, kb,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "tt_inner_launch")
    tt_inner.launches += 1
    return out


tt_inner.launches = 0
