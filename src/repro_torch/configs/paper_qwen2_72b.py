"""Qwen2-72B — the paper's largest evaluation model.

[arXiv:2407.10671] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    citation="arXiv:2407.10671 (Qwen2)",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    block_pattern=(ATTN,),
    qkv_bias=True,
    rope="full",
    rope_theta=1_000_000.0,
)
