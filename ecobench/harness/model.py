"""A configuration file's model, in the benchmark's own terms.

``Model`` is read from the ``model`` block of ``configs/<name>.json``; the
file's top-level keys are the source's ``config.json`` as it is run, and
``test_ecobench_configs`` holds the two to each other.  Nothing here
imports the port.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]      # ecobench/


@dataclasses.dataclass(frozen=True)
class Model:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool
    rope_dims: int          # leading head dims the rotary turns
    rope_theta: float
    norm_eps: float

    @property
    def group(self) -> int:
        return self.heads // self.kv_heads

    def layer_matmul_params(self) -> int:
        """Weights a token multiplies in one layer (q, k, v, o, SwiGLU)."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.heads * hd * 2 + 2 * d * self.kv_heads * hd
        return attn + 3 * d * self.d_ff


def load_config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def model_of(conf: dict) -> Model:
    return Model(**conf["model"])
