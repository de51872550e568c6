"""ModelConfig: one dataclass drives every assigned architecture."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    act: str = "swiglu"               # swiglu | geglu | gelu
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    use_rope: bool = True
    scale_embed: bool = False         # gemma: embeddings * sqrt(d_model)
    tie_embeddings: bool = False

    block: str = "attn_dense"         # attn_dense | attn_moe | ssm | hybrid
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    moe_every: int = 1            # 2 = alternate dense/MoE layers (llama4)
    d_ff_dense: int = 0           # FFN width of the interleaved dense layers
    # SSM / Mamba2 (SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4
    # hybrid (zamba2): one shared attn+mlp block applied every `period` layers
    shared_attn_period: int = 0
    # attention
    sliding_window: int = 0           # 0 = full attention
    # LSH attention (the paper's CP-SRP applied to long context)
    lsh_attention: bool = False
    lsh_num_hashes: int = 8           # SRP bits -> 2^bits buckets
    lsh_rank: int = 2                 # CP rank R of the projection tensors
    lsh_chunk: int = 512              # bucket-chunk size (prefill)
    lsh_candidates: int = 1024        # candidate set size (decode)
    lsh_recent: int = 128             # always-attended recency window (decode)
    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0              # audio frames after the (stubbed) conv frontend
    # multimodal stub (pixtral): precomputed patch embeddings prepended
    vision_tokens: int = 0

    dtype: str = "bfloat16"
    remat_policy: str = "nothing"     # nothing | dots | none  (see transformer._remat)
    scan_unroll: bool = False         # dry-run aux: unroll layer scans so
                                      # cost_analysis counts every layer

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        """Embedding/LM-head vocab padded to a multiple of 256 so the vocab
        dim always shards over the model axis (whisper's 51865 / mamba2's
        50280 otherwise replicate the (B,S,V) loss tensors — a 13 GiB/chip
        bug caught by the dry-run). Labels never reference padded ids."""
        return -(-self.vocab_size // 256) * 256

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_channels(self) -> int:
        # mamba2 convolves the concatenated [x, B, C] streams
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def is_ssm_block(self) -> bool:
        return self.block in ("ssm", "hybrid")

    @property
    def active_params_per_token_experts(self) -> int:
        """Experts actually touched per token (top_k + shared)."""
        return (self.top_k + self.n_shared_experts) if self.n_experts else 0

    def validate(self) -> "ModelConfig":
        assert self.n_layers > 0 and self.d_model > 0
        if self.block == "attn_moe":
            assert self.n_experts > 0 and self.top_k > 0
            if self.moe_every == 2:
                assert self.n_layers % 2 == 0 and self.d_ff_dense > 0
            else:
                assert self.moe_every == 1
        if self.block in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        if self.block == "hybrid":
            assert self.shared_attn_period > 0
            assert self.n_layers % self.shared_attn_period == 0
        if self.encoder_decoder:
            assert self.n_encoder_layers > 0 and self.encoder_seq > 0
        return self
