"""Qwen3-4B — dense GQA decoder with per-head q/k RMSNorm.

[hf:Qwen/Qwen3-8B family] 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm.
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    citation="hf:Qwen/Qwen3-8B (Qwen3 family card)",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151_936,
    block_pattern=(ATTN,),
    qk_norm=True,
    rope="full",
    rope_theta=1_000_000.0,
)
