"""RWKV-6 "Finch" 3B — attention-free RNN with data-dependent decay.

[arXiv:2404.05892] 32L d_model=2560 d_ff=8960 vocab=65536.  Time-mix block
keeps a per-head (head_dim x head_dim) state; decode is O(1) in context.
"""
from repro_torch.configs.base import ModelConfig, RWKV6

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    citation="arXiv:2404.05892 (RWKV-6 Finch)",
    num_layers=32,
    d_model=2560,
    num_heads=40,          # wkv heads (head_dim 64); attention-free
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    block_pattern=(RWKV6,),
    rope="none",
)
