"""Architecture registry: --arch <id> -> (full config, smoke config)
(the port's own copy of ``repro.configs``, field for field).

All 10 assigned architectures plus the paper's own LSH-service workload.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini",
    "mistral-large-123b": "repro_torch.configs.mistral_large",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
}

ARCH_IDS = tuple(_MODULES)

# archs with a sub-quadratic long-context path (DESIGN.md §Arch-applicability)
LONG_CONTEXT_ARCHS = {
    "zamba2-7b": "ssm-hybrid (constant state + windowed shared-attn KV)",
    "mamba2-130m": "ssm (constant state)",
    "mixtral-8x22b": "sliding-window attention (ring KV cache)",
    "phi3-mini-3.8b": "CP-SRP LSH attention variant (the paper's technique)",
}


def get_config(arch: str, variant: str = "full") -> ModelConfig:
    """variant: 'full' | 'smoke' | 'long' (long_500k-capable variant)."""
    mod = importlib.import_module(_MODULES[arch])
    if variant == "smoke":
        return mod.SMOKE
    if variant == "long":
        if hasattr(mod, "LONG_CONTEXT"):
            return mod.LONG_CONTEXT
        return mod.CONFIG
    return mod.CONFIG


def supports_long_context(arch: str) -> bool:
    return arch in LONG_CONTEXT_ARCHS
