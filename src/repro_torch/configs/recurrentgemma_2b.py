"""RecurrentGemma-2B — Griffin hybrid: (RG-LRU, RG-LRU, local-attn) blocks.

[arXiv:2402.19427] 26L d_model=2560 10H (GQA kv=1, head_dim=256 in the
paper; we keep d_model/num_heads=256) d_ff=7680 vocab=256000, local
attention window 2048, logit soft cap 30.
"""
from repro_torch.configs.base import ModelConfig, RGLRU, LOCAL_ATTN

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    citation="arXiv:2402.19427 (RecurrentGemma / Griffin)",
    num_layers=26,          # 26 blocks; pattern cycles (rglru, rglru, local)
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    sliding_window=2048,
    rope="full",
    logit_soft_cap=30.0,
    tie_embeddings=True,
)
