"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

Perf-hillclimb cell #1 (biggest dense model; FSDP + TP).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab_size=32768,
    act="swiglu", norm="rmsnorm",
).validate()

SMOKE = ModelConfig(
    name="mistral-large-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    d_ff=160, vocab_size=256,
    act="swiglu", norm="rmsnorm", dtype="float32",
).validate()
