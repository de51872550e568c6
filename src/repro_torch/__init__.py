"""PyTorch + CUDA port of the tensorized-LSH system (reference: ``repro``).

The CP, TT and dense serving paths: ``build_service`` -> CP hashing
(kernel K3, ``kernels/csrc/cp_gram.cu``), TT hashing (kernel K4,
``kernels/csrc/tt_inner.cu``) or the dense hash (fp32 matrix products, the
naive kinds and dense corpora) -> per-table sorted keys -> fused query with
the re-rank in the corpus' format (kernel K1,
``kernels/csrc/fused_query.cu``; CP, TT or dense rows), with
streaming mutations, and with ``shards=S`` the sharded index on the same
card (K1s: K1's kernel over every (shard, segment) pair). The LM
substrate's serving path: ``configs``, ``models`` (dense, MoE, SSD, hybrid,
encoder-decoder and the CP-SRP LSH attention), ``data`` and
``serving/engine.py``, and its training (``training``: AdamW, remat,
accumulation, the CP-sketch gradient compression, checkpoints, the
fault-tolerant loop; ``launch/train.py``). Entry points default to ``device="cuda"``;
``device="cpu"`` runs every kernel's plain PyTorch version. This package
imports torch and numpy, never JAX or ``repro``.

Importing it turns TF32 off for float32 matmuls and convolutions: TF32
rounds inputs to a 10-bit mantissa, which flips hash codes next to bucket
edges and moves re-rank scores away from the reference's float32. It also
turns off cuBLAS's reduced-precision reduction for bfloat16 products
(``allow_bf16_reduced_precision_reduction``): the reference's bfloat16
einsums accumulate in float32, and a split-K reduction in bfloat16 would
not.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
