"""Format adaptation around the kernels (reference: ``repro.kernels.ops``).

The kernels read CP factors stacked across modes:

  * a batch of CP inputs, per mode (B, d_n, R) -> (B, N, d, R);
  * the L*K stacked projections, per mode (L*K, d_n, R) -> (N, L, K, d, R);

with every mode padded to the largest d by zero rows (a zero row adds an
exact zero to every Gram, so ragged mode dims need no separate path). The
TPU's (8, 128) tile padding and the batch padding to the grid block are
gone: the CUDA kernels mask the ragged edge of the batch themselves.

``fused_hash`` is the one entry from a stacked batch to hash outputs that
``LSHFamily`` calls; it runs K3 (``cp_gram``) on the tensors' device. A
family stacks its projections once; a query batch is stacked once
(``stack_cp``) and read by both K3 and K1.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.projections import CPProjection
from repro_torch.core.tensor_formats import CPTensor
from repro_torch.kernels.cp_gram import cp_gram


def _pad_axis(a: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``a`` up to ``size``."""
    pad = size - a.shape[axis]
    if pad == 0:
        return a
    widths = [0, 0] * (a.dim() - axis - 1) + [0, pad]
    return torch.nn.functional.pad(a, widths)


def _stack_cp_batch(x: CPTensor) -> torch.Tensor:
    """Batched CP factors (each (B, d_n, R)) -> (B, N, d, R) float32, modes
    zero-padded to the largest d_n."""
    d = max(x.dims)
    return torch.stack([_pad_axis(f.float(), 1, d) for f in x.factors], dim=1)


def _stack_cp_proj(p: CPProjection, num_tables: int) -> torch.Tensor:
    """Projection factors (each (L*K, d_n, R)) -> (N, L, K, d, R), modes
    zero-padded to the largest d_n."""
    d = max(p.dims)
    pf = torch.stack([_pad_axis(f.float(), 1, d) for f in p.factors], dim=0)
    n, kt, _, rp = pf.shape
    return pf.reshape(n, num_tables, kt // num_tables, d, rp)


def stack_cp(x: CPTensor) -> tuple[CPTensor, torch.Tensor]:
    """-> (the batch with factors that are views of ``stacked``, stacked
    (B, N, d, R) float32), so the plain path and the kernels read the same
    memory and a batch is stacked once."""
    stacked = _stack_cp_batch(x).contiguous()
    views = tuple(stacked[:, i, :dn] for i, dn in enumerate(x.dims))
    return CPTensor(views, x.scale), stacked


def mults_tensor(mults, device) -> torch.Tensor:
    """(K,) uint32 multipliers (numpy, or a tensor of their values) -> int64
    tensor on ``device``; a tensor already there is returned as it is."""
    if not isinstance(mults, torch.Tensor):
        mults = torch.from_numpy(np.asarray(mults, np.uint32).astype(np.int64))
    return mults.to(device, torch.int64)


def fused_hash(xf: torch.Tensor, pf: torch.Tensor, *, scale: float,
               epilogue: str, kind: str, offsets: torch.Tensor | None = None,
               w: float = 0.0, mults=None) -> torch.Tensor:
    """One K3 call from a stacked (B, N, d, Rx) CP batch and the stacked
    (N, L, K, d, Rp) projections to hash outputs; ``scale`` is the product
    of the batch's and the projection's scales.

    epilogue:
      'raw'    -> (B, L, K) float32 raw <P, X> values
      'codes'  -> (B, L, K) int32 hashcodes (E2LSH floor / SRP sign)
      'keys'   -> (B, L) uint32 bucket keys in int64 (discretize + radix
                  combine with the (K,) ``mults``)
      'packed' -> (B, L, ceil(K/32)) uint32 SRP signatures in int64
    """
    e2 = kind.endswith("e2lsh")
    kernel_epilogue = {
        "raw": "raw",
        "codes": "e2lsh" if e2 else "srp",
        "keys": "e2lsh-keys" if e2 else "srp-keys",
        "packed": "srp-packed",
    }[epilogue]
    if epilogue == "packed" and e2:
        raise ValueError("packed signatures are defined for SRP kinds only")
    if xf.device != pf.device:
        raise ValueError(f"inputs on {xf.device}, family on {pf.device}")
    _, num_tables, num_codes, _, _ = pf.shape
    offs = (offsets.reshape(num_tables, num_codes)
            if e2 and offsets is not None else None)
    mults_t = None
    if epilogue == "keys":
        mults_t = mults_tensor(mults, pf.device).reshape(num_codes)
    return cp_gram(xf, pf, offs, mults_t, epilogue=kernel_epilogue,
                   w=float(w) if e2 else 1.0, scale=float(scale))
