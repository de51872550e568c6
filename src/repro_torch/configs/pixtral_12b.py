"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — pixtral-ViT + mistral-nemo [hf:mistralai/Pixtral-12B-2409].

The ViT frontend is a STUB per the assignment: input_specs() provides 1024
precomputed patch embeddings that replace the first 1024 token positions
(early fusion); the loss masks image positions.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    act="swiglu", norm="rmsnorm",
    vision_tokens=1024,
).validate()

SMOKE = ModelConfig(
    name="pixtral-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    act="swiglu", norm="rmsnorm",
    vision_tokens=8, dtype="float32",
).validate()
