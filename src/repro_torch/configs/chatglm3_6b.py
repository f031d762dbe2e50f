"""ChatGLM3-6B — dense GQA decoder with rotary applied to half the head dim.

[arXiv:2406.12793] 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    citation="arXiv:2406.12793 (ChatGLM)",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65_024,
    block_pattern=(ATTN,),
    qkv_bias=True,        # chatglm uses bias on qkv only
    rope="half",          # 2d rope: rotary on first half of head_dim
)
