"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b; unverified]. LayerNorm + full-head GQA
(kv=32 == MHA). Published model uses partial rotary (25%); we apply full
rotary and record the approximation in DESIGN.md.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab_size=50304,
    act="swiglu", norm="layernorm",
).validate()

SMOKE = ModelConfig(
    name="stablelm-3b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    act="swiglu", norm="layernorm", dtype="float32",
).validate()
