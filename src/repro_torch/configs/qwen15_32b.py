"""Qwen1.5-32B — dense MHA-like decoder (kv=40) with QKV bias.

[hf:Qwen/Qwen1.5 family card] 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064.
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    citation="hf:Qwen/Qwen1.5-0.5B (family card)",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152_064,
    block_pattern=(ATTN,),
    qkv_bias=True,
    rope="full",
    rope_theta=1_000_000.0,
)
