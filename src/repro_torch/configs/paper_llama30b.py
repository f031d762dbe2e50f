"""Llama-30B — the paper's MHA evaluation model (Table 3 / Fig. 8).

[arXiv:2302.13971] 60L d_model=6656 52H (MHA) d_ff=17920 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="llama-30b",
    family="dense",
    citation="arXiv:2302.13971 (LLaMA)",
    num_layers=60,
    d_model=6656,
    num_heads=52,
    num_kv_heads=52,
    d_ff=17920,
    vocab_size=32_000,
    block_pattern=(ATTN,),
    rope="full",
)
