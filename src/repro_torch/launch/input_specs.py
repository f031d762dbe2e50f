"""Input shapes and meta-tensor stand-ins for every (arch x shape)
(``repro.launch.input_specs``).

The four assigned input shapes; ``batch_specs`` returns tensors on the
``meta`` device (shape and dtype, no allocation) where the reference
returns ``ShapeDtypeStruct``s: what the dry run's steps take.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """None if the pair runs; otherwise the documented skip reason."""
    if shape.kind == "decode":
        if cfg.is_encoder:
            return "encoder-only architecture has no decode step"
        if shape.seq_len > 100_000 and not cfg.subquadratic:
            return ("pure full-attention arch: 524k dense KV cache is "
                    "quadratic; skipped per DESIGN.md (use *-sw variant)")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape,
                act_dtype=torch.bfloat16) -> Dict[str, Any]:
    """Model-input stand-ins (tokens/frames/patches [+ labels for train]),
    int32 ids as the reference's."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    out: Dict[str, Any] = {}
    if cfg.modality == "audio":
        out["frames"] = _meta((B, S, cfg.frontend_dim), act_dtype)
        if shape.kind == "train":
            out["labels"] = _meta((B, S), i32)
        return out
    if cfg.modality == "vision" and shape.kind != "decode":
        P = cfg.num_patches
        out["tokens"] = _meta((B, S - P), i32)
        out["patches"] = _meta((B, P, cfg.frontend_dim), act_dtype)
        if shape.kind == "train":
            out["labels"] = _meta((B, S - P), i32)
        return out
    if shape.kind == "decode":
        out["tokens"] = _meta((B, 1), i32)
    else:
        out["tokens"] = _meta((B, S), i32)
        if shape.kind == "train":
            out["labels"] = _meta((B, S), i32)
    return out
