"""Weights drawn from the seed by the benchmark, handed to both sides.

One ``torch.randn`` fills a flat buffer in the served dtype on the device
of the generator; each leaf is a contiguous view of it, scaled in place.
Scales: the embedding and the head 0.02; q and k 2 / sqrt(d), so a score
q.k / sqrt(D) has a standard deviation near 4 and attention picks few
keys (a wrong cache row or position then shows in the tokens); v, o and
the SwiGLU's in-projections 1 / sqrt(fan in); the qkv biases 0.5; each
RMSNorm's weight 1 + 0.1 z, stored as its offset from 1 (``*_norm``).

``port_params`` lays the same tensors out as ``repro_torch``'s params
dict (its RMSNorm multiplies by 1 + scale, its weights are (in, out)):
views, no copies.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ecobench.harness.model import Model

Weights = Dict[str, object]


def layout(m: Model) -> List[Tuple[str, tuple, float]]:
    """(name, shape, scale) of every leaf, in the order drawn."""
    d, hd, f = m.d_model, m.head_dim, m.d_ff
    qk = 2.0 * d ** -0.5
    out = [("embed", (m.vocab, d), 0.02), ("final_norm", (d,), 0.1),
           ("lm_head", (d, m.vocab), 0.02)]
    for i in range(m.layers):
        p = f"layers.{i}."
        out += [(p + "attn_norm", (d,), 0.1),
                (p + "wq", (d, m.heads * hd), qk),
                (p + "wk", (d, m.kv_heads * hd), qk),
                (p + "wv", (d, m.kv_heads * hd), d ** -0.5),
                (p + "wo", (m.heads * hd, d), (m.heads * hd) ** -0.5)]
        if m.qkv_bias:
            out += [(p + "bq", (m.heads * hd,), 0.5),
                    (p + "bk", (m.kv_heads * hd,), 0.5),
                    (p + "bv", (m.kv_heads * hd,), 0.5)]
        out += [(p + "mlp_norm", (d,), 0.1),
                (p + "w_gate", (d, f), d ** -0.5),
                (p + "w_up", (d, f), d ** -0.5),
                (p + "w_down", (f, d), f ** -0.5)]
    return out


def n_elements(m: Model) -> int:
    n = 0
    for _, shape, _ in layout(m):
        k = 1
        for s in shape:
            k *= s
        n += k
    return n


def draw(m: Model, seed: int, dtype=torch.bfloat16,
         device="cuda") -> Weights:
    """All leaves from one generator seeded with ``seed`` on ``device``:
    {"embed", "final_norm", "lm_head", "layers": [{name: tensor}]}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n_elements(m), generator=gen, dtype=dtype,
                       device=device)
    w: Weights = {"layers": [{} for _ in range(m.layers)]}
    at = 0
    for name, shape, scale in layout(m):
        k = 1
        for s in shape:
            k *= s
        t = flat[at:at + k].view(shape).mul_(scale)
        at += k
        if name.startswith("layers."):
            _, i, leaf = name.split(".")
            w["layers"][int(i)][leaf] = t
        else:
            w[name] = t
    return w


def port_params(w: Weights, m: Model) -> dict:
    """``w`` as the port's ``params`` (same storage)."""
    layers = []
    for lw in w["layers"]:
        core = {k: lw[k] for k in ("wq", "wk", "wv", "wo")}
        if m.qkv_bias:
            core.update({k: lw[k] for k in ("bq", "bk", "bv")})
        layers.append({"norm1": {"scale": lw["attn_norm"]}, "core": core,
                       "norm2": {"scale": lw["mlp_norm"]},
                       "ffn": {k: lw[k] for k in ("w_gate", "w_up",
                                                  "w_down")}})
    return {"embed": w["embed"], "final_norm": {"scale": w["final_norm"]},
            "lm_head": w["lm_head"], "layers": layers}
