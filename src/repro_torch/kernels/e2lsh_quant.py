"""K7: E2LSH floor-quantize (reference:
``repro.kernels.e2lsh_quant.e2lsh_quant_pallas`` behind
``ops.e2lsh_quantize``).

    values (B, K) float32, offsets (K,), width w -> int32 (B, K)
    = floor((values + offsets) / w)

The division is a true IEEE division by w, as the reference's oracle
``ref.e2lsh_quant_ref``, ``lsh.e2lsh_discretize`` and the fused epilogues
compute it; the reference's Pallas kernel multiplies by 1/w instead, which
floors differently next to bucket edges for widths that are not powers of
two (ROADMAP.md, R4). ``e2lsh_quant`` launches the CUDA kernel
``csrc/e2lsh_quant.cu`` on CUDA tensors and runs the plain version
``e2lsh_quant_plain`` on CPU tensors; any other device raises.
``e2lsh_quant.launches`` counts kernel launches, ``e2lsh_quant_plain.calls``
calls of the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.epilogues import div_w


def e2lsh_quant_plain(values: torch.Tensor, offsets: torch.Tensor,
                      w: float) -> torch.Tensor:
    """Plain PyTorch version of K7: (B, K), (K,) -> int32 (B, K)."""
    e2lsh_quant_plain.calls += 1
    return torch.floor(div_w(values.float() + offsets.float(), w)).to(
        torch.int32)


e2lsh_quant_plain.calls = 0


def e2lsh_quant(values: torch.Tensor, offsets: torch.Tensor,
                w: float) -> torch.Tensor:
    """K7 on the tensors' device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    dev = values.device
    if values.dim() != 2 or tuple(offsets.shape) != (values.shape[1],):
        raise ValueError(f"e2lsh_quant takes (B, K) values and (K,) offsets, "
                         f"got {tuple(values.shape)} and "
                         f"{tuple(offsets.shape)}")
    if offsets.device != dev:
        raise ValueError(f"values on {dev}, offsets on {offsets.device}")
    if dev.type == "cpu":
        return e2lsh_quant_plain(values, offsets, w)
    if dev.type != "cuda":
        raise ValueError(f"e2lsh_quant runs on cuda or cpu tensors, got {dev}")
    from repro_torch.kernels import _build

    b, k = values.shape
    v = values.contiguous().float()
    offs = offsets.contiguous().float()
    out = torch.empty((b, k), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    err = _build.lib().e2lsh_quant_launch(
        v.data_ptr(), offs.data_ptr(), out.data_ptr(), b, k, float(w),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "e2lsh_quant_launch")
    e2lsh_quant.launches += 1
    return out


e2lsh_quant.launches = 0
