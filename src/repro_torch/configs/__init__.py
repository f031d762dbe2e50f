"""Architecture registry.

``get_config(arch_id)`` returns the full assigned configuration;
``get_smoke_config(arch_id)`` returns a reduced variant of the same family
(<=2 layers, d_model<=512, <=4 experts) for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llama3-8b": "llama3_8b",
    "llama3-8b-sw": "llama3_8b_sw",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "qwen3-4b": "qwen3_4b",
    "hubert-xlarge": "hubert_xlarge",
    "llama4-scout-17b-a16e": "llama4_scout",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen1.5-32b": "qwen15_32b",
    "chatglm3-6b": "chatglm3_6b",
    "rwkv6-3b": "rwkv6_3b",
    # the paper's own evaluation models
    "llama-30b": "paper_llama30b",
    "codellama2-34b": "paper_codellama34b",
    "qwen2-72b": "paper_qwen2_72b",
}

# The ten assigned architectures (llama3-8b-sw is a documented extra
# variant used only for long_500k; paper models are for the benchmarks).
ASSIGNED: List[str] = [
    "recurrentgemma-2b",
    "llama3-8b",
    "phi3.5-moe-42b-a6.6b",
    "qwen3-4b",
    "hubert-xlarge",
    "llama4-scout-17b-a16e",
    "qwen2-vl-2b",
    "qwen1.5-32b",
    "chatglm3-6b",
    "rwkv6-3b",
]

_cache: Dict[str, ModelConfig] = {}


def available_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _cache:
        if arch_id not in _MODULES:
            raise KeyError(
                f"unknown arch {arch_id!r}; available: {sorted(_MODULES)}")
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
        _cache[arch_id] = mod.CONFIG
    return _cache[arch_id]


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    cfg = get_config(arch_id)
    pattern = cfg.block_pattern
    n_layers = max(2, len(pattern))  # keep at least one full pattern cycle
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = max(1, min(cfg.num_kv_heads, heads)) if heads else 0
    d_model = 256
    updates = dict(
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64 if heads else 0,
        d_ff=512,
        vocab_size=min(cfg.vocab_size, 512),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        num_experts=min(cfg.num_experts, 4),
        top_k=min(cfg.top_k, 2),
        frontend_dim=min(cfg.frontend_dim, 64) if cfg.frontend_dim else 0,
        num_patches=min(cfg.num_patches, 16) if cfg.num_patches else 0,
    )
    return dataclasses.replace(cfg, **updates)
