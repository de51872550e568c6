"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + 1 shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Text backbone only (listed as [moe]); interleaved RoPE/NoPE simplified to
RoPE everywhere (DESIGN.md). MoE layers alternate with dense layers
(d_ff 16384), as in the published model — that is what makes the totals
400B/17B-active work out from d_ff=8192 x 128 experts. 128 experts divide
the 16-way model axis -> true expert parallelism. Perf-hillclimb cell #2
(MoE dispatch collectives).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    act="swiglu", norm="rmsnorm",
    block="attn_moe", n_experts=128, top_k=1, n_shared_experts=1,
    capacity_factor=1.25, moe_every=2, d_ff_dense=16384,
).validate()

SMOKE = ModelConfig(
    name="llama4-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256,
    act="swiglu", norm="rmsnorm",
    block="attn_moe", n_experts=8, top_k=1, n_shared_experts=1,
    capacity_factor=1.5, moe_every=2, d_ff_dense=128, dtype="float32",
).validate()
