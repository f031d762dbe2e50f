"""CodeLlama2-34B — the paper's GQA evaluation model.

[arXiv:2308.12950] 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=32016.
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="codellama2-34b",
    family="dense",
    citation="arXiv:2308.12950 (Code Llama)",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=32_016,
    block_pattern=(ATTN,),
    rope="full",
    rope_theta=1_000_000.0,
)
