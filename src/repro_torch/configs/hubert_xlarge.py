"""HuBERT X-Large — encoder-only audio transformer (wav2vec2-style arch).

[arXiv:2106.07447] 48L d_model=1280 16H (MHA, kv=16) d_ff=5120 vocab=504.
The conv feature-extractor frontend is a STUB per the brief: input_specs()
provides precomputed frame embeddings (B, S, frontend_dim).
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    citation="arXiv:2106.07447 (HuBERT)",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    block_pattern=(ATTN,),
    is_encoder=True,
    rope="none",          # hubert uses conv positional embedding; stubbed
    modality="audio",
    frontend_dim=512,
)
