"""Qwen2-VL-2B — VLM language backbone with M-RoPE.

[arXiv:2409.12191] 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
The ViT frontend is a STUB per the brief: input_specs() provides patch
embeddings (B, num_patches, frontend_dim) + (t, h, w) positions; M-RoPE
splits the rotary dims into three position components.
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    citation="arXiv:2409.12191 (Qwen2-VL)",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    block_pattern=(ATTN,),
    qkv_bias=True,
    rope="mrope",
    rope_theta=1_000_000.0,
    modality="vision",
    frontend_dim=1152,     # SigLIP-style patch embedding dim
    num_patches=1024,
)
