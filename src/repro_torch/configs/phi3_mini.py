"""phi3-mini-3.8b [dense] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

`LONG_CONTEXT` is the long_500k variant with the paper's CP-SRP LSH
attention enabled (phi3 is otherwise pure full attention and would skip
that cell — see DESIGN.md §Arch-applicability).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    act="swiglu", norm="rmsnorm",
).validate()

LONG_CONTEXT = ModelConfig(
    name="phi3-mini-3.8b-lsh",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    act="swiglu", norm="rmsnorm",
    lsh_attention=True, lsh_num_hashes=8, lsh_rank=2,
    lsh_chunk=512, lsh_candidates=2048, lsh_recent=128,
).validate()

SMOKE = ModelConfig(
    name="phi3-mini-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    act="swiglu", norm="rmsnorm", dtype="float32",
    lsh_attention=True, lsh_num_hashes=4, lsh_rank=2,
    lsh_chunk=16, lsh_candidates=32, lsh_recent=8,
).validate()
