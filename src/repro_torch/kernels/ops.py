"""Format adaptation around the kernels (reference: ``repro.kernels.ops``).

The kernels read CP factors and TT cores stacked across modes:

  * a batch of CP inputs, per mode (B, d_n, R) -> (B, N, d, R);
  * the L*K stacked CP projections, per mode (L*K, d_n, R) ->
    (N, L, K, d, R);
  * a batch of TT inputs, per mode (B, r_{n-1}, d_n, r_n) -> (B, N, R, d, R);
  * the L*K stacked TT projections -> (N, L, K, R, d, R);

with every mode padded to the largest d by zero rows (a zero row adds an
exact zero to every Gram and every chain step, so ragged mode dims need no
separate path), and the TT boundary ranks zero-padded to R: the chain then
starts from e_00 and reads S[0, 0], the same values. The TPU's (8, 128)
tile padding and the batch padding to the grid block are gone: the CUDA
kernels mask the ragged edge of the batch themselves.

A dense batch is stacked as flat (B, prod d) float32 rows.

``fused_hash`` is the entry from a stacked batch to hash outputs that
``LSHFamily`` calls for CP on CP and TT on TT; it runs K3 (``cp_gram``) or
K4 (``tt_inner``) on the tensors' device. A family stacks its projections
once; a corpus or a query batch is stacked once (its format's ``stack``,
which calls ``stack_cp`` or ``stack_tt``) and read by the hash kernel and
K1. For the pairs the reference's ``fused_hash`` refuses (a dense
projection on any input, a CP or TT projection on dense input) the family
calls ``dense_hash`` on the values of ``projections.project_batch`` (fp32
matrix products with TF32 off, the reference's XLA path): its discretize,
combine and pack tails are the torch counterparts of the reference's
``lsh._discretize``, ``_combine_codes`` and ``pack_bits``, not the plain
version of any kernel. ``unstack_as`` reads a stacked batch back as a
format object for it.

The standalone kernel-level API, as the reference's tests and
``benchmarks/kernels.py`` call it: ``cp_inner_products`` /
``tt_inner_products`` (one input's K raw values through K3 / K4, scales
applied) and the discretization tails ``srp_pack`` (K6) and
``e2lsh_quantize`` (K7). The reference's ``block_b`` / ``interpret`` knobs
tile and emulate the TPU and have no counterpart: the CUDA kernels mask
ragged shapes themselves, and the tensors' device picks the kernel or its
plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.projections import CPProjection, TTProjection
from repro_torch.core.tensor_formats import CPTensor, DenseTensor, TTTensor
from repro_torch.kernels.cp_gram import cp_gram
from repro_torch.kernels.epilogues import apply_epilogue
# the standalone tails as the reference's ``ops`` names them: srp_pack (K6)
# and e2lsh_quantize (K7)
from repro_torch.kernels.e2lsh_quant import e2lsh_quant as e2lsh_quantize
from repro_torch.kernels.srp_pack import srp_pack
from repro_torch.kernels.tt_inner import tt_inner


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
    return unstack_like(x, stacked), stacked


def _stack_tt_cores(cores, rank: int, axis: int) -> torch.Tensor:
    """Per-mode cores (each (M, r, d_n, r')) -> one zero-padded float32
    tensor with the modes on ``axis`` (1: (M, N, R, d, R); 0:
    (N, M, R, d, R)). Written in place, so no padded copy of a core is
    made on the way."""
    m, n, d = cores[0].shape[0], len(cores), max(c.shape[2] for c in cores)
    shape = (m, n, rank, d, rank) if axis == 1 else (n, m, rank, d, rank)
    out = torch.zeros(shape, dtype=torch.float32, device=cores[0].device)
    for i, c in enumerate(cores):
        dst = out[:, i] if axis == 1 else out[i]
        dst[:, :c.shape[1], :c.shape[2], :c.shape[3]] = c
    return out


def _stack_tt_batch(x: TTTensor, rank: int | None = None) -> torch.Tensor:
    """Batched TT cores (each (B, r, d_n, r')) -> (B, N, R, d, R) float32:
    ranks zero-padded to ``rank`` (default the batch's largest), modes to
    the largest d_n."""
    return _stack_tt_cores(x.cores, x.rank if rank is None else rank, 1)


def _stack_tt_proj(p: TTProjection, num_tables: int) -> torch.Tensor:
    """Projection cores (each (L*K, r, d_n, r')) -> (N, L, K, Rp, d, Rp),
    ranks and modes zero-padded."""
    pc = _stack_tt_cores(p.cores, p.rank, 0)
    n, kt, rp, d, _ = pc.shape
    return pc.reshape(n, num_tables, kt // num_tables, rp, d, rp)


def stack_tt(x: TTTensor) -> tuple[TTTensor, torch.Tensor]:
    """-> (the batch with cores that are views of ``stacked``, stacked
    (B, N, R, d, R) float32): the corpus is held on the card once, the
    plain path reads the views at their true ranks, the kernels the padded
    tensor."""
    stacked = _stack_tt_batch(x)
    return unstack_like(x, stacked), stacked


def unstack_like(x, stacked: torch.Tensor):
    """A stacked tensor with any leading dims ((..., N, d, R) CP,
    (..., N, R, d, R) TT, (..., prod d) dense) -> a tensor of ``x``'s
    format, mode dims, ranks and scale whose leaves are views of
    ``stacked``: ``x``'s rows gathered, padded or split into shards keep
    one copy."""
    if x.layout == "dense":
        return DenseTensor(stacked.view(stacked.shape[:-1] + tuple(x.dims)),
                           x.dims)
    if x.layout == "cp":
        return CPTensor(tuple(stacked[..., i, :dn, :]
                              for i, dn in enumerate(x.dims)), x.scale)
    return TTTensor(tuple(stacked[..., i, :c.shape[-3], :c.shape[-2],
                                  :c.shape[-1]]
                          for i, c in enumerate(x.cores)), x.scale)


# the layout of a stacked batch by its rank: (B, prod d), (B, N, d, R),
# (B, N, R, d, R)
_STACKED_LAYOUTS = {2: "dense", 4: "cp", 5: "tt"}


def stacked_layout(xf: torch.Tensor) -> str:
    """'dense', 'cp' or 'tt': the format of a stacked batch."""
    return _STACKED_LAYOUTS[xf.dim()]


def unstack_as(layout: str, xf: torch.Tensor, dims, scale: float):
    """A stacked batch of ``layout`` -> a format object of mode ``dims`` and
    ``scale`` over views of it (TT cores at the padded ranks, whose zero
    rows add exact zeros)."""
    if layout == "dense":
        return DenseTensor(xf.view((xf.shape[0],) + tuple(dims)), tuple(dims))
    if layout == "cp":
        return CPTensor(tuple(xf[:, i, :dn, :] for i, dn in enumerate(dims)),
                        scale)
    return TTTensor(tuple(xf[:, i, :, :dn, :] for i, dn in enumerate(dims)),
                    scale)


def dense_hash(values: torch.Tensor, *, epilogue: str, kind: str,
               num_tables: int, offsets: torch.Tensor | None = None,
               w: float = 0.0, mults=None) -> torch.Tensor:
    """(B, L*K) raw values of the dense route -> the outputs of
    ``fused_hash``'s ``epilogue`` ('raw' (B, L, K), 'codes', 'keys',
    'packed'): the reference's XLA tails (floor((v + b) / w) with a true
    division, sign, the uint32 radix combine, the bit pack) in torch."""
    e2 = kind.endswith("e2lsh")
    if epilogue == "packed" and e2:
        raise ValueError("packed signatures are defined for SRP kinds only")
    b = values.shape[0]
    v = values.reshape(b, num_tables, -1)
    num_codes = v.shape[2]
    offs = offsets.reshape(num_tables, num_codes) if e2 else None
    mults_t = (mults_tensor(mults, v.device).reshape(num_codes)
               if epilogue == "keys" else None)
    return apply_epilogue(v, offs, mults_t, epilogue=_EPILOGUES[epilogue](e2),
                          w=float(w) if e2 else 1.0)


def mults_tensor(mults, device) -> torch.Tensor:
    """(K,) uint32 multipliers (numpy, or a tensor of their values) -> int64
    tensor on ``device``; a tensor already there is returned as it is."""
    if not isinstance(mults, torch.Tensor):
        mults = torch.from_numpy(np.asarray(mults, np.uint32).astype(np.int64))
    return mults.to(device, torch.int64)


# the epilogue of the hash tails for a family's output and its kind
_EPILOGUES = {
    "raw": lambda e2: "raw",
    "codes": lambda e2: "e2lsh" if e2 else "srp",
    "keys": lambda e2: "e2lsh-keys" if e2 else "srp-keys",
    "packed": lambda e2: "srp-packed",
}

# the hash kernel of each format's ``layout`` and the rank of its stacked
# projections
HASH_KERNELS = {"cp": (cp_gram, 5), "tt": (tt_inner, 6)}


def fused_hash(xf: torch.Tensor, pf: torch.Tensor, *, scale: float,
               epilogue: str, kind: str, layout: str,
               offsets: torch.Tensor | None = None, w: float = 0.0,
               mults=None) -> torch.Tensor:
    """One K3 call (``layout`` 'cp') from a stacked (B, N, d, Rx) CP batch
    and the stacked (N, L, K, d, Rp) projections, or one K4 call ('tt')
    from a stacked (B, N, Rx, d, Rx) TT batch and the stacked
    (N, L, K, Rp, d, Rp) projections, to hash outputs; ``scale`` is the
    product of the batch's and the projection's scales.

    epilogue:
      'raw'    -> (B, L, K) float32 raw <P, X> values
      'codes'  -> (B, L, K) int32 hashcodes (E2LSH floor / SRP sign)
      'keys'   -> (B, L) uint32 bucket keys in int64 (discretize + radix
                  combine with the (K,) ``mults``)
      'packed' -> (B, L, ceil(K/32)) uint32 SRP signatures in int64
    """
    e2 = kind.endswith("e2lsh")
    kernel_epilogue = _EPILOGUES[epilogue](e2)
    if epilogue == "packed" and e2:
        raise ValueError("packed signatures are defined for SRP kinds only")
    if xf.device != pf.device:
        raise ValueError(f"inputs on {xf.device}, family on {pf.device}")
    kernel, p_dim = HASH_KERNELS[layout]
    if pf.dim() != p_dim or xf.dim() + 1 != p_dim:
        raise ValueError(f"stacked inputs {tuple(xf.shape)} and projections "
                         f"{tuple(pf.shape)} are not the {layout} layout")
    num_tables, num_codes = pf.shape[1], pf.shape[2]
    offs = (offsets.reshape(num_tables, num_codes)
            if e2 and offsets is not None else None)
    mults_t = None
    if epilogue == "keys":
        mults_t = mults_tensor(mults, pf.device).reshape(num_codes)
    return kernel(xf, pf, offs, mults_t, epilogue=kernel_epilogue,
                  w=float(w) if e2 else 1.0, scale=float(scale))


# ---------------------------------------------------------------------------
# The standalone kernel-level API (reference: ops.cp_inner_products,
# tt_inner_products; srp_pack and e2lsh_quantize are imported above)
# ---------------------------------------------------------------------------


def _check_equal_dims(dims) -> None:
    if len(set(dims)) != 1:
        raise ValueError(
            f"kernel path needs equal mode dims, got {dims}; use the "
            "repro_torch.core.projections path for ragged modes")


def cp_inner_products(x: CPTensor, p: CPProjection) -> torch.Tensor:
    """(K,) raw <P_k, X> values (scales applied) of one CP input through
    K3, the batch-of-1 case of the batch-native kernel."""
    _check_equal_dims(x.dims)
    _check_equal_dims(p.dims)
    xf = _stack_cp_batch(CPTensor(tuple(f[None] for f in x.factors),
                                  x.scale))
    out = cp_gram(xf, _stack_cp_proj(p, 1), epilogue="raw")
    return (x.scale * p.scale) * out[0, 0]


def tt_inner_products(x: TTTensor, p: TTProjection) -> torch.Tensor:
    """(K,) raw <T_k, X> values (scales applied) of one TT input through
    K4, the batch-of-1 case of the batch-native kernel."""
    _check_equal_dims(x.dims)
    _check_equal_dims(p.dims)
    xf = _stack_tt_batch(TTTensor(tuple(c[None] for c in x.cores), x.scale))
    out = tt_inner(xf, _stack_tt_proj(p, 1), epilogue="raw")
    return (x.scale * p.scale) * out[0, 0]
