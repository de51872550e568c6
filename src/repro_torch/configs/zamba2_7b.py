"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks
[arXiv:2411.15242; unverified].

We model 81 Mamba2 layers with ONE weight-shared attention+MLP block
applied every 9 layers (9 applications); the published model interleaves
two shared blocks with LoRA specialization — same compute pattern, see
DESIGN.md. SSM state is per-arch (64); long_500k runs natively.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    act="swiglu", norm="rmsnorm",
    block="hybrid", shared_attn_period=9,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_groups=1, ssm_chunk=256,
).validate()

SMOKE = ModelConfig(
    name="zamba2-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    act="swiglu", norm="rmsnorm",
    block="hybrid", shared_attn_period=2,
    ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_groups=1, ssm_chunk=8,
    dtype="float32",
).validate()
