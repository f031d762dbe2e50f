"""Model configuration system.

A ``ModelConfig`` fully describes one architecture from the assigned pool
(or one of the paper's own evaluation models).  Families share one
composable transformer implementation in ``repro_torch.models``; the config
selects the block pattern, attention flavour, MoE settings, etc.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds usable in ``block_pattern`` (repeated cyclically over layers).
ATTN = "attn"          # global causal attention (bidirectional if encoder)
LOCAL_ATTN = "local"   # sliding-window causal attention
RGLRU = "rglru"        # RG-LRU recurrent block (Griffin / RecurrentGemma)
RWKV6 = "rwkv6"        # RWKV-6 "Finch" time-mix block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    citation: str                # source paper / model card
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attention-free archs)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # --- block structure -------------------------------------------------
    block_pattern: Tuple[str, ...] = (ATTN,)
    sliding_window: int = 0      # window for LOCAL_ATTN blocks
    is_encoder: bool = False     # bidirectional, no decode phase (hubert)

    # --- attention flavour ------------------------------------------------
    qk_norm: bool = False        # qwen3: RMSNorm on q and k heads
    qkv_bias: bool = False       # qwen1.5 / qwen2-vl
    rope: str = "full"           # full | half (chatglm 2d) | mrope | none
    rope_theta: float = 10_000.0

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- modality frontend stub --------------------------------------------
    modality: str = "text"       # text | audio | vision
    frontend_dim: int = 0        # embedding dim produced by the stub frontend
    num_patches: int = 0         # vlm: patches provided per sample

    # --- norms / misc -------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_soft_cap: float = 0.0  # recurrentgemma uses 30.0

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------ #
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attention_free(self) -> bool:
        return all(b in (RGLRU, RWKV6) for b in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if no block attends to unbounded context (long_500k eligible)."""
        return all(
            b in (RGLRU, RWKV6) or (b == LOCAL_ATTN and self.sliding_window > 0)
            for b in self.block_pattern
        )

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length num_layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    # --- parameter counting (for roofline MODEL_FLOPS = 6 N D) ----------- #
    def param_count(self, active_only: bool = False) -> int:
        d, h = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in self.block_kinds():
            if kind in (ATTN, LOCAL_ATTN):
                attn = d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
            elif kind == RGLRU:
                # w_x, w_gate, w_out, w_in_gate, w_rec_gate (+conv, small)
                attn = 5 * d * d
            elif kind == RWKV6:
                # r,k,v,g,o projections + decay lora
                attn = 5 * d * d + 2 * d * 64
            else:  # pragma: no cover
                raise ValueError(kind)
            if kind == RWKV6:
                ffn = 2 * d * self.d_ff          # squared-relu channel mix
            elif self.is_moe:
                n_eff = self.top_k if active_only else self.num_experts
                ffn = n_eff * 3 * d * self.d_ff + d * self.num_experts
            else:
                ffn = 3 * d * self.d_ff          # gated (SwiGLU-style) MLP
            total += attn + ffn
        return total

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache (or recurrent-state amortized) bytes per token of context."""
        per_layer = 0
        for kind in self.block_kinds():
            if kind == ATTN:
                per_layer += 2 * self.num_kv_heads * self.head_dim * dtype_bytes
            elif kind == LOCAL_ATTN:
                per_layer += 2 * self.num_kv_heads * self.head_dim * dtype_bytes
            # recurrent blocks hold O(1) state -> 0 per token
        return per_layer
