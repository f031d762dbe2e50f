"""Llama-3-8B — dense GQA decoder with a 128k vocabulary.

[arXiv:2407.21783] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    citation="arXiv:2407.21783 (The Llama 3 Herd of Models)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128_256,
    block_pattern=(ATTN,),
    rope="full",
    rope_theta=500_000.0,
)
