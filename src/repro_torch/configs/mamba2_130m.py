"""mamba2-130m [ssm] — 24L d_model=768 (attn-free) d_ff=0 vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060; unverified].

Pure Mamba2: d_inner=1536, 24 SSD heads of dim 64, constant-size state ->
long_500k decode is O(1) per token. Attention-LSH is inapplicable
(attention-free; DESIGN.md §Arch-applicability).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12,  # unused (attn-free)
    d_ff=0, vocab_size=50280,
    block="ssm", tie_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1, ssm_chunk=256,
).validate()

SMOKE = ModelConfig(
    name="mamba2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=256,
    block="ssm", tie_embeddings=True,
    ssm_state=16, ssm_expand=2, ssm_head_dim=32, ssm_groups=1, ssm_chunk=8,
    dtype="float32",
).validate()
