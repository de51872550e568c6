"""whisper-tiny [audio] — 4L d_model=384 6H (GQA kv=6) d_ff=1536
vocab=51865 — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

4 encoder + 4 decoder layers, LayerNorm, GELU, learned positions (no RoPE).
The conv frontend is a STUB: input_specs() provides 1500 precomputed frame
embeddings (30 s of audio). Decode cells drive the decoder to the assigned
lengths mechanically (32k decode is not a natural Whisper workload).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab_size=51865,
    act="gelu", norm="layernorm", use_rope=False,
    encoder_decoder=True, n_encoder_layers=4, encoder_seq=1500,
).validate()

SMOKE = ModelConfig(
    name="whisper-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256,
    act="gelu", norm="layernorm", use_rope=False,
    encoder_decoder=True, n_encoder_layers=2, encoder_seq=32,
    dtype="float32",
).validate()
