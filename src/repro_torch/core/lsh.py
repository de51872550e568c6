"""The paper's tensorized LSH families (Definitions 10-13) and the naive
baselines, in PyTorch.

  CP-E2LSH (Def. 10):  g(X)  = floor((<P, X> + b) / w),  P ~ CP_Rad(R)
  TT-E2LSH (Def. 11):  g~(X) = floor((<T, X> + b) / w),  T ~ TT_Rad(R)
  CP-SRP   (Def. 12):  h(X)  = sign(<P, X>),             P ~ CP_Rad(R)
  TT-SRP   (Def. 13):  h~(X) = sign(<T, X>),             T ~ TT_Rad(R)
  E2LSH    (Def. 3):   floor((<M, vec X> + b) / w),      M Gaussian
  SRP      (Def. 2):   sign(<M, vec X>),                 M Gaussian

A family carries K x L hash functions (K codes per table, L tables).
Hashing is batch-native: ``hash_batch`` maps a (B, ...) batch to (B, L, K)
int32 codes, ``hash_keys`` to (B, L) bucket keys and, for the SRP kinds,
``hash_packed_batch`` to (B, L, ceil(K/32)) packed signatures; ``hash`` and
``hash_packed`` are their batch-of-one cases for a single tensor. Two
routes:

  * CP inputs under a CP family, TT under TT: ``ops.fused_hash``, the K3
    (CP) or K4 (TT) kernel when the inputs lie on the card, its plain
    version when they lie on the CPU (the reference's ``fused_hash``);
  * every other pair (a dense projection (``e2lsh``, ``srp``) on inputs of
    any format, a CP or TT projection on dense inputs, CP inputs under a TT
    family and TT under CP): ``ops.dense_hash``, the fp32 products and
    contractions of ``projections.project_batch`` and the torch tails (the
    reference's XLA path; it has no kernel for these pairs).

There is no backend knob; the tensors' device decides.

Bucket keys are uint32 values held in int64 tensors in [0, 2^32): the radix
combine sum_k codes[k] * mults[k] wraps mod 2^32 exactly as the reference's
uint32 arithmetic does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import projections as proj_lib
from repro_torch.core.projections import (CPProjection, DenseProjection,
                                          TTProjection)
from repro_torch.core.tensor_formats import batch_of_one
from repro_torch.device import resolve_device
# pack_bits: {0, 1} codes along the last axis -> uint32 words (the
# reference's ``lsh.pack_bits``)
from repro_torch.kernels.epilogues import U32_MASK, div_w, mul_u32, pack_bits

E2LSH_KINDS = ("cp-e2lsh", "tt-e2lsh", "e2lsh")
SRP_KINDS = ("cp-srp", "tt-srp", "srp")
ALL_KINDS = E2LSH_KINDS + SRP_KINDS


def e2lsh_discretize(values: torch.Tensor, b: torch.Tensor,
                     w: float) -> torch.Tensor:
    """floor((v + b) / w) -> int32 hashcode (paper Eq. 3.3). Divides by w
    (never multiplies by 1/w), as the reference does."""
    return torch.floor(div_w(values + b, w)).to(torch.int32)


def srp_discretize(values: torch.Tensor) -> torch.Tensor:
    """sign(v) in {0, 1} (paper Eq. 3.1): 1 iff v > 0."""
    return (values > 0).to(torch.int32)


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of ``pack_bits``, truncated back to K bits -> int32."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :k].to(torch.int32)


def _combine_codes(codes: torch.Tensor, mults: torch.Tensor) -> torch.Tensor:
    """(..., L, K) int codes -> (..., L) uint32 bucket keys in int64:
    sum_k uint32(codes[k]) * mults[k] mod 2^32."""
    prods = mul_u32(codes.to(torch.int64) & U32_MASK,
                    mults.to(codes.device, torch.int64))
    return prods.sum(dim=-1) & U32_MASK


def make_mults(seed: int, num_codes: int) -> np.ndarray:
    """Per-position odd uint32 multipliers for the universal bucket hash
    (bit-identical to the reference's numpy ``make_mults``)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(num_codes,), dtype=np.uint32) | 1


@dataclasses.dataclass(frozen=True)
class LSHFamily:
    """A (K, L)-amplified LSH family of one of the six kinds. ``projection``
    holds K*L stacked projection tensors (or the naive kinds' (L*K, prod d)
    matrix); ``offsets`` (E2LSH only) the b ~ U[0, w) per hash."""

    projection: CPProjection | TTProjection | DenseProjection
    offsets: torch.Tensor | None          # (L*K,) or None for SRP
    kind: str
    num_codes: int                        # K
    num_tables: int                       # L
    bucket_width: float = 0.0

    @property
    def device(self) -> torch.device:
        return self.projection.leaves[0].device

    @property
    def input_format(self) -> type:
        """CPTensor, TTTensor or DenseTensor: the format of the family's
        projections (``check_inputs`` says which inputs it hashes)."""
        return self.projection.input_format

    def to(self, device) -> "LSHFamily":
        """The same family with its parameters on ``device``."""
        p = self.projection
        return dataclasses.replace(
            self, projection=p.with_leaves(t.to(device) for t in p.leaves),
            offsets=None if self.offsets is None else self.offsets.to(device))

    def uses_kernel(self, layout: str) -> bool:
        """Whether inputs of ``layout`` hash through K3 / K4 (CP on CP, TT
        on TT) rather than ``ops.dense_hash``."""
        return layout == self.projection.layout != "dense"

    def storage_size(self) -> int:
        """Stored scalars of the projection parameters (paper Tables
        1-2)."""
        return self.projection.storage_size()

    def _discretize(self, values: torch.Tensor) -> torch.Tensor:
        """(B, L*K) raw values -> (B, L, K) int32 codes."""
        if self.kind in E2LSH_KINDS:
            codes = e2lsh_discretize(values, self.offsets, self.bucket_width)
        else:
            codes = srp_discretize(values)
        return codes.reshape(values.shape[0], self.num_tables, self.num_codes)

    @functools.cached_property
    def stacked_projection(self) -> torch.Tensor:
        """The projections in the hash kernel's layout, stacked once per
        family: (N, L, K, d, Rp) for K3, (N, L, K, Rp, d, Rp) for K4."""
        return self.projection.stacked(self.num_tables)

    def check_inputs(self, xs) -> None:
        """Raise unless ``xs`` is a batch of this family's mode dims (any
        format: CP on CP and TT on TT hash through K3 / K4, every other
        pair through ``projections.project_batch``)."""
        p = self.projection
        if tuple(xs.dims) != tuple(p.dims):
            raise ValueError(f"inputs of dims {xs.dims} under a family of "
                             f"dims {p.dims}")

    def stack(self, xs) -> torch.Tensor:
        """A batch in the kernels' layout: (B, N, d, R) float32 for CP,
        (B, N, R, d, R) for TT, (B, prod d) dense."""
        self.check_inputs(xs)
        return xs.stack()[1]

    def _fused(self, xf: torch.Tensor, scale: float, epilogue: str,
               mults=None) -> torch.Tensor:
        from repro_torch.kernels import ops
        layout = ops.stacked_layout(xf)
        if not self.uses_kernel(layout):
            values = proj_lib.project_batch(
                self.projection,
                ops.unstack_as(layout, xf, self.projection.dims, scale))
            return ops.dense_hash(values, epilogue=epilogue, kind=self.kind,
                                  num_tables=self.num_tables,
                                  offsets=self.offsets, w=self.bucket_width,
                                  mults=mults)
        return ops.fused_hash(xf, self.stacked_projection,
                              scale=scale * self.projection.scale,
                              epilogue=epilogue, kind=self.kind,
                              layout=layout, offsets=self.offsets,
                              w=self.bucket_width, mults=mults)

    def raw_stacked(self, xf: torch.Tensor, scale: float) -> torch.Tensor:
        """(B, L*K) raw <P_k, X> values of a stacked batch (``stack``) of
        scale ``scale``, through the hash path (the K3 or K4 kernel's
        ``raw`` epilogue on the card, or ``ops.dense_hash``'s products over
        fixed row chunks): the same arithmetic as the build keys, so an item
        queried as itself lands in its own buckets."""
        return self._fused(xf, scale, "raw").reshape(
            -1, self.num_tables * self.num_codes)

    def raw_projections(self, x) -> torch.Tensor:
        """(L*K,) raw <P_k, X> values of one tensor, through
        ``projections.project`` (the plain projection path)."""
        return proj_lib.project(self.projection, x)

    def hash_batch_aux(self, xs) -> tuple[torch.Tensor, torch.Tensor]:
        """(codes (B, L, K) int32, aux (B, L, K) float32): ``aux`` is the
        floor residual (v + b)/w - floor((v + b)/w) for E2LSH and the raw
        value v for SRP, evaluated on the plain projection path as in the
        reference (the tests read code-boundary margins from it); on the
        dense route that path is the hash path itself."""
        if self.uses_kernel(xs.layout):
            values = proj_lib.project_batch(self.projection, xs)
        else:
            values = self.raw_stacked(self.stack(xs), xs.scale)
        codes = self._discretize(values)
        if self.kind in E2LSH_KINDS:
            t = div_w(values + self.offsets, self.bucket_width)
            aux = t.reshape(codes.shape) - codes.to(values.dtype)
        else:
            aux = values.reshape(codes.shape)
        return codes, aux

    def hash_batch(self, xs) -> torch.Tensor:
        """(B, L, K) int32 codes: projection -> discretize, one fused call."""
        return self._fused(self.stack(xs), xs.scale, "codes")

    def hash_keys(self, xs, mults) -> torch.Tensor:
        """(B, L) bucket keys (uint32 values in int64): projection ->
        discretize -> radix combine, one fused call; equal to
        ``_combine_codes(self.hash_batch(xs), mults)``."""
        return self._fused(self.stack(xs), xs.scale, "keys", mults=mults)

    def hash_packed_batch(self, xs) -> torch.Tensor:
        """SRP only: (B, L, ceil(K/32)) packed signatures (uint32 values in
        int64), sign and bit-pack in one fused call (the K3 / K4
        ``srp-packed`` epilogue); equal to ``pack_bits(self.hash_batch(xs))``
        on the same device."""
        if self.kind not in SRP_KINDS:
            raise ValueError("hash_packed is defined for SRP kinds only")
        return self._fused(self.stack(xs), xs.scale, "packed")

    def hash(self, x) -> torch.Tensor:
        """(L, K) int32 codes of one tensor: ``hash_batch`` of the batch of
        one (K3 for CP under CP, K4 for TT under TT on the card)."""
        return self.hash_batch(batch_of_one(x))[0]

    def hash_packed(self, x) -> torch.Tensor:
        """SRP only: (L, ceil(K/32)) packed signatures of one tensor
        (uint32 values in int64), through ``hash_packed_batch``."""
        return self.hash_packed_batch(batch_of_one(x))[0]


def make_family(gen: torch.Generator, kind: str, dims: Sequence[int],
                num_codes: int = 8, num_tables: int = 1, rank: int = 4,
                bucket_width: float = 4.0, device="cuda") -> LSHFamily:
    """Sample a family of any of the six kinds ('cp-e2lsh' | 'cp-srp' |
    'tt-e2lsh' | 'tt-srp' | 'e2lsh' | 'srp') on the generator's device and
    place it on ``device``. The naive kinds draw a Gaussian (L*K, prod d)
    matrix (Definitions 2-3; ``rank`` unused), the tensorized ones
    Rademacher factors or cores (Definitions 6-7)."""
    if kind not in ALL_KINDS:
        raise ValueError(f"kind must be one of {ALL_KINDS}, got {kind!r}")
    dev = resolve_device(device)
    total = num_codes * num_tables
    if kind.startswith("cp-"):
        p = proj_lib.sample_cp_projection(gen, total, dims, rank)
    elif kind.startswith("tt-"):
        p = proj_lib.sample_tt_projection(gen, total, dims, rank)
    else:
        p = proj_lib.sample_dense_projection(gen, total, dims)
    p = p.with_leaves(t.to(dev) for t in p.leaves)
    offsets = None
    if kind in E2LSH_KINDS:
        offsets = (torch.rand(total, generator=gen, device=gen.device)
                   * bucket_width).to(dev)
    return LSHFamily(projection=p, offsets=offsets, kind=kind,
                     num_codes=num_codes, num_tables=num_tables,
                     bucket_width=float(bucket_width))


def naive_storage_size(dims: Sequence[int], num_codes: int,
                       num_tables: int) -> int:
    """O(K d^N) scalars the naive method stores (paper Tables 1-2)."""
    return num_codes * num_tables * int(math.prod(dims))
