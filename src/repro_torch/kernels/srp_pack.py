"""K6: SRP sign bits packed little-endian into uint32 words (reference:
``repro.kernels.srp_pack.srp_pack_pallas`` behind ``ops.srp_pack``).

    values (B, K) float32 -> (B, ceil(K/32)) uint32 words in int64,
    bit j of word w of row b = values[b, 32w + j] > 0

Columns past K are 0 (the reference pads K with -1.0), and 0.0, -0.0 and
NaN give bit 0. ``srp_pack`` launches the CUDA kernel ``csrc/srp_pack.cu``
on CUDA tensors and runs the plain version ``srp_pack_plain`` on CPU
tensors; any other device raises. ``srp_pack.launches`` counts kernel
launches, ``srp_pack_plain.calls`` calls of the plain version.

``plan`` sizes the launch from the shape, the card's SM count and the
values' alignment: ``THREADS`` threads a block, ``MIN_BLOCKS`` blocks a SM,
each warp walking chunks of rows (a row stream of about ``CHUNK_BYTES``,
or one word-aligned piece of a longer row) in a grid-stride loop. Where K
is a multiple of 4 and the values are 16-byte aligned a lane reads float4
units (the vector path), else single floats (the scalar path). The C launch
recomputes the plan and refuses one that differs, so these copies of the
source's constants cannot drift.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.counts import count_launch, counted
from repro_torch.kernels.epilogues import pack_bits, sm_count

# the source's constants (csrc/srp_pack.cu: kThreads, kMinBlocks,
# kChunkBytes, kStageWords, kLaneBytes)
THREADS = 512
WARPS = THREADS // 32
MIN_BLOCKS = 2
CHUNK_BYTES = 8192       # values a warp chunk of short rows holds
STAGE_WORDS = 256        # words a warp chunk may hold
LANE_BYTES = 64          # bytes a lane loads before it uses any


class Plan(NamedTuple):
    """A K6 launch: its path ("vector": float4 units, "scalar": floats),
    threads a block, the grid's blocks, the rows a warp chunk holds, the
    pieces a row is cut into (1: rows whole) and a piece's units, the
    chunks, the resident blocks per SM it was sized for and the bytes its
    loads keep in flight on each SM there."""
    path: str
    threads: int
    blocks: int
    rows: int
    pieces: int
    piece: int
    chunks: int
    target_blocks: int
    in_flight: int

    @property
    def block_rows(self) -> int:
        """Rows a block's warps cover in one grid-stride step (whole rows;
        a cut row counts once for each of its pieces)."""
        return self.rows * WARPS


def plan(b: int, k: int, sms: int, aligned: bool) -> Plan:
    """K6's launch for (``b``, ``k``) values on a card of ``sms`` SMs;
    ``aligned``: the values' address is a multiple of 16 bytes (``srp_plan``
    in the source)."""
    vector = k % 4 == 0 and aligned
    v = 4 if vector else 1
    ku, words = k // v, -(-k // 32)
    chunk_units = CHUNK_BYTES // (4 * v)
    if ku > chunk_units:
        rows, piece, pieces = 1, chunk_units, -(-ku // chunk_units)
        chunks = b * pieces
    else:
        warps = MIN_BLOCKS * sms * WARPS
        rows = max(1, min(chunk_units // ku, STAGE_WORDS // words,
                          b // warps))
        piece, pieces = ku, 1
        chunks = -(-b // rows)
    blocks = min(-(-chunks // WARPS), MIN_BLOCKS * sms)
    return Plan("vector" if vector else "scalar", THREADS, blocks, rows,
                pieces, piece, chunks, MIN_BLOCKS,
                MIN_BLOCKS * THREADS * LANE_BYTES)


def occupancy(p: Plan) -> dict:
    """What the card makes of the kernel a plan runs: registers a thread,
    resident blocks per SM and local (spilled) bytes a thread."""
    import ctypes

    from repro_torch.kernels import _build

    out = (ctypes.c_int * 3)()
    _build.check(_build.lib().srp_pack_occupancy(
        int(p.path == "vector"), ctypes.addressof(out)), "srp_pack_occupancy")
    return dict(registers=out[0], blocks_per_sm=out[1], local_bytes=out[2])


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
    p = plan(b, k, sm_count(dev), v.data_ptr() % 16 == 0)
    if p.chunks >= 1 << 31:
        raise ValueError(f"srp_pack takes fewer than 2^31 chunks; "
                         f"({b}, {k}) needs {p.chunks}")
    with torch.cuda.device(dev):   # the launch goes to the tensors' card
        err = _build.lib().srp_pack_launch(
            v.data_ptr(), out.data_ptr(), b, k, p.threads, p.blocks, p.rows,
            p.pieces, int(p.path == "vector"),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "srp_pack_launch")
    count_launch(srp_pack)
    return out


counted(srp_pack)
