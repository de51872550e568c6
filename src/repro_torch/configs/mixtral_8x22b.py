"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088; hf].

Sliding window 4096 (per the assignment's SWA note) -> long_500k runs with a
window-sized ring KV cache. 8 experts on a 16-way model axis do not divide
-> the sharding fallback yields tensor-parallel experts (see models/moe.py).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    act="swiglu", norm="rmsnorm",
    block="attn_moe", n_experts=8, top_k=2, capacity_factor=1.25,
    sliding_window=4096,
).validate()

SMOKE = ModelConfig(
    name="mixtral-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256,
    act="swiglu", norm="rmsnorm",
    block="attn_moe", n_experts=4, top_k=2, capacity_factor=1.5,
    sliding_window=16, dtype="float32",
).validate()
