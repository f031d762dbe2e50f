"""Llama-4 Scout (17B active, 16 experts) — MoE top-1, chunked attention.

[hf:meta-llama/Llama-4-Scout-17B-16E] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 16e top-1, early fusion.  Scout's model card
uses chunked (local) attention on most layers, enabling 500k+ contexts —
we model every block as sliding-window 8192, which keeps long_500k
sub-quadratic.
"""
from repro_torch.configs.base import ModelConfig, LOCAL_ATTN

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    block_pattern=(LOCAL_ATTN,),
    sliding_window=8192,
    num_experts=16,
    top_k=1,
    rope="full",
)
