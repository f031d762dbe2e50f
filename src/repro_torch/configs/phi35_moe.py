"""Phi-3.5-MoE (42B total, 6.6B active) — 16 experts, top-2 routing.

[hf:microsoft/Phi-3.5-MoE-instruct] 32L d_model=4096 32H (GQA kv=8)
d_ff=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    block_pattern=(ATTN,),
    num_experts=16,
    top_k=2,
    rope="full",
)
