"""The port's kernels and their plain PyTorch versions.

  cp_gram.py      K3: fused CP x CP hashing (csrc/cp_gram.cu)
  tt_inner.py     K4: fused TT x TT hashing, the chain (csrc/tt_inner.cu)
  fused_query.py  K1: discretize -> probe -> dedup -> CP or TT re-rank ->
                  top-k (csrc/fused_query.cu); K1s: the same kernel over
                  every (shard, segment) pair of a sharded store
  epilogues.py    hash epilogues and probe helpers as plain PyTorch
  ops.py          format stacking and ``fused_hash``
  ref.py          plain oracles
  parity.py       the rounding bounds kernels and plain versions are held to
  _build.py       nvcc build (sm_90a) and ctypes binding, at first use

A wrapper launches its CUDA kernel for CUDA tensors and runs the plain
version for CPU tensors; nothing falls back from one to the other.
"""
