"""K6: SRP sign bits packed little-endian into uint32 words (reference:
``repro.kernels.srp_pack.srp_pack_pallas`` behind ``ops.srp_pack``).

    values (B, K) float32 -> (B, ceil(K/32)) uint32 words in int64,
    bit j of word w of row b = values[b, 32w + j] > 0

Columns past K are 0 (the reference pads K with -1.0), and 0.0 gives bit 0.
``srp_pack`` launches the CUDA kernel ``csrc/srp_pack.cu`` on CUDA tensors
and runs the plain version ``srp_pack_plain`` on CPU tensors; any other
device raises. ``srp_pack.launches`` counts kernel launches,
``srp_pack_plain.calls`` calls of the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.epilogues import pack_bits


def srp_pack_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: (B, K) -> (B, ceil(K/32)) words."""
    srp_pack_plain.calls += 1
    return pack_bits(values > 0)


srp_pack_plain.calls = 0


def srp_pack(values: torch.Tensor) -> torch.Tensor:
    """K6 on the tensor's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    dev = values.device
    if values.dim() != 2:
        raise ValueError(f"srp_pack takes (B, K) values, got "
                         f"{tuple(values.shape)}")
    if dev.type == "cpu":
        return srp_pack_plain(values)
    if dev.type != "cuda":
        raise ValueError(f"srp_pack runs on cuda or cpu tensors, got {dev}")
    from repro_torch.kernels import _build

    b, k = values.shape
    v = values.contiguous().float()
    out = torch.empty((b, -(-k // 32)), dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    err = _build.lib().srp_pack_launch(
        v.data_ptr(), out.data_ptr(), b, k,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "srp_pack_launch")
    srp_pack.launches += 1
    return out


srp_pack.launches = 0
