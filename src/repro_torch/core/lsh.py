"""The paper's tensorized LSH families (Definitions 10-13) in PyTorch.

  CP-E2LSH (Def. 10):  g(X)  = floor((<P, X> + b) / w),  P ~ CP_Rad(R)
  TT-E2LSH (Def. 11):  g~(X) = floor((<T, X> + b) / w),  T ~ TT_Rad(R)
  CP-SRP   (Def. 12):  h(X)  = sign(<P, X>),             P ~ CP_Rad(R)
  TT-SRP   (Def. 13):  h~(X) = sign(<T, X>),             T ~ TT_Rad(R)

A family carries K x L hash functions (K codes per table, L tables) and
hashes inputs of its own format (CP inputs under a CP family, TT under TT).
Hashing is batch-native: ``hash_batch`` maps a (B, ...) batch to (B, L, K)
int32 codes and ``hash_keys`` to (B, L) bucket keys, both through
``repro_torch.kernels.ops.fused_hash``: the K3 (CP) or K4 (TT) kernel when
the inputs lie on the card, its plain version when they lie on the CPU.
There is no backend knob; the tensors' device decides.

Bucket keys are uint32 values held in int64 tensors in [0, 2^32): the radix
combine sum_k codes[k] * mults[k] wraps mod 2^32 exactly as the reference's
uint32 arithmetic does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import projections as proj_lib
from repro_torch.core.projections import CPProjection, TTProjection
from repro_torch.device import resolve_device
from repro_torch.kernels.epilogues import U32_MASK, div_w, mul_u32

E2LSH_KINDS = ("cp-e2lsh", "tt-e2lsh")
SRP_KINDS = ("cp-srp", "tt-srp")
ALL_KINDS = E2LSH_KINDS + SRP_KINDS
_QUEUED_KINDS = ("e2lsh", "srp")


def e2lsh_discretize(values: torch.Tensor, b: torch.Tensor,
                     w: float) -> torch.Tensor:
    """floor((v + b) / w) -> int32 hashcode (paper Eq. 3.3). Divides by w
    (never multiplies by 1/w), as the reference does."""
    return torch.floor(div_w(values + b, w)).to(torch.int32)


def srp_discretize(values: torch.Tensor) -> torch.Tensor:
    """sign(v) in {0, 1} (paper Eq. 3.1): 1 iff v > 0."""
    return (values > 0).to(torch.int32)


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
    """A (K, L)-amplified CP or TT LSH family. ``projection`` holds K*L
    stacked projection tensors; ``offsets`` (E2LSH only) the b ~ U[0, w)
    per hash."""

    projection: CPProjection | TTProjection
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
        """CPTensor or TTTensor: the inputs this family hashes."""
        return self.projection.input_format

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
        """Raise unless ``xs`` is a batch of the family's format and mode
        dims."""
        if not isinstance(xs, self.input_format):
            raise NotImplementedError(
                f"a {self.kind} family hashes {self.input_format.__name__} "
                f"inputs; {type(xs).__name__} under it is queued in "
                "ROADMAP.md (cross-format pairs, dense corpora)")
        if xs.dims != self.projection.dims:
            raise ValueError(f"inputs of dims {xs.dims} under a family of "
                             f"dims {self.projection.dims}")

    def stack(self, xs) -> torch.Tensor:
        """A batch in the hash kernel's layout: (B, N, d, R) float32 for CP,
        (B, N, R, d, R) for TT."""
        self.check_inputs(xs)
        return xs.stack()[1]

    def _fused(self, xf: torch.Tensor, scale: float, epilogue: str,
               mults=None) -> torch.Tensor:
        from repro_torch.kernels import ops
        return ops.fused_hash(xf, self.stacked_projection,
                              scale=scale * self.projection.scale,
                              epilogue=epilogue, kind=self.kind,
                              layout=self.input_format.layout,
                              offsets=self.offsets, w=self.bucket_width,
                              mults=mults)

    def raw_stacked(self, xf: torch.Tensor, scale: float) -> torch.Tensor:
        """(B, L*K) raw <P_k, X> values of a stacked batch (``stack``) of
        scale ``scale``, through the fused hash path (the K3 or K4 kernel's
        ``raw`` epilogue on the card): the same arithmetic as the build
        keys, so an item queried as itself lands in its own buckets."""
        return self._fused(xf, scale, "raw").reshape(
            -1, self.num_tables * self.num_codes)

    def hash_batch_aux(self, xs) -> tuple[torch.Tensor, torch.Tensor]:
        """(codes (B, L, K) int32, aux (B, L, K) float32): ``aux`` is the
        floor residual (v + b)/w - floor((v + b)/w) for E2LSH and the raw
        value v for SRP, evaluated on the plain projection path as in the
        reference (the tests read code-boundary margins from it)."""
        values = proj_lib.project_batch(self.projection, xs)
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


def make_family(gen: torch.Generator, kind: str, dims: Sequence[int],
                num_codes: int = 8, num_tables: int = 1, rank: int = 4,
                bucket_width: float = 4.0, device="cuda") -> LSHFamily:
    """Sample a CP or TT family ('cp-e2lsh' | 'cp-srp' | 'tt-e2lsh' |
    'tt-srp') on the generator's device and place it on ``device``. The
    dense kinds are queued."""
    if kind in _QUEUED_KINDS:
        raise NotImplementedError(
            f"kind {kind!r} is queued in ROADMAP.md (dense corpora); the "
            "port serves the CP and TT kinds")
    if kind not in ALL_KINDS:
        raise ValueError(f"kind must be one of {ALL_KINDS}, got {kind!r}")
    dev = resolve_device(device)
    total = num_codes * num_tables
    sample = (proj_lib.sample_cp_projection if kind.startswith("cp-")
              else proj_lib.sample_tt_projection)
    p = sample(gen, total, dims, rank)
    p = type(p)(tuple(t.to(dev) for t in p.leaves), p.scale)
    offsets = None
    if kind in E2LSH_KINDS:
        offsets = (torch.rand(total, generator=gen, device=gen.device)
                   * bucket_width).to(dev)
    return LSHFamily(projection=p, offsets=offsets, kind=kind,
                     num_codes=num_codes, num_tables=num_tables,
                     bucket_width=float(bucket_width))
