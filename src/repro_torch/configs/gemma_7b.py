"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256 [arXiv:2403.08295; hf].

Embeddings scaled by sqrt(d_model), tied LM head (as published).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    act="geglu", norm="rmsnorm", scale_embed=True, tie_embeddings=True,
).validate()

SMOKE = ModelConfig(
    name="gemma-7b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=192, vocab_size=512,
    act="geglu", norm="rmsnorm", scale_embed=True, tie_embeddings=True,
    dtype="float32",
).validate()
