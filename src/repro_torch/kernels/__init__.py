"""The port's kernels and their plain PyTorch versions.

  cp_gram.py      K3: fused CP x CP hashing (csrc/cp_gram.cu)
  tt_inner.py     K4: fused TT x TT hashing, the chain (csrc/tt_inner.cu)
  fused_query.py  K1: discretize -> probe -> dedup -> CP or TT re-rank ->
                  top-k (csrc/fused_query.cu); K1s: the same kernel over
                  every (shard, segment) pair of a sharded store
  srp_pack.py     K6: standalone SRP sign bits packed into uint32 words
                  (csrc/srp_pack.cu)
  e2lsh_quant.py  K7: standalone E2LSH floor((v + b) / w)
                  (csrc/e2lsh_quant.cu)
  epilogues.py    hash epilogues and probe helpers as plain PyTorch
  ops.py          format stacking, ``fused_hash`` and the standalone API
                  (``cp_inner_products``, ``tt_inner_products``,
                  ``srp_pack``, ``e2lsh_quantize``)
  ref.py          plain oracles
  parity.py       the rounding bounds kernels and plain versions are held to
  _build.py       nvcc build (sm_90a) and ctypes binding, at first use

A wrapper launches its CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors; nothing falls back from one to the other.
"""

from repro_torch.kernels import ref
from repro_torch.kernels.ops import (cp_inner_products, e2lsh_quantize,
                                     fused_hash, srp_pack, tt_inner_products)
