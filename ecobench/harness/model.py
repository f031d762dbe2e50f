"""A configuration file's model, in the benchmark's own terms.

A configuration file's ``family`` (``dense`` where it names none) is the
module ``families/<family>.py``, which gives the model's ``Model`` (read
from the file's ``model`` block), its weights, its plain reference, the
port's configuration fields it has to match and its work counts
(``FAMILY``).  The file's top-level keys are the source's ``config.json``
as it is run; ``test_ecobench_schema`` holds the two to each other through
the family's ``SOURCE_KEYS``.  ``Model`` below is the dense family's.
Nothing here imports the port.
"""
from __future__ import annotations

import dataclasses
from types import ModuleType

from ecobench.harness import files

# what a family module gives (families/dense.py is the worked example)
FAMILY = ("Model", "SOURCE_KEYS", "draw", "port_params", "port_fields",
          "logits_at", "prefill_flops", "decode_flops")


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
    return files.read_json("configs", name)


def family_of(conf: dict) -> ModuleType:
    """The family module of a configuration file."""
    name = conf.get("family", "dense")
    fam = files.module("families", name)
    missing = [k for k in FAMILY if not hasattr(fam, k)]
    if missing:
        raise AttributeError(f"families/{name}.py lacks {', '.join(missing)}")
    return fam


def model_of(conf: dict):
    return family_of(conf).Model(**conf["model"])
