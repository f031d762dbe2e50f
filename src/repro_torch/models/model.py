"""Dense GQA decoder: init / forward / cache, in PyTorch.

Counterpart of ``repro.models.model`` for the main serving path.  The JAX
package stacks layers per pattern position and scans over them; here
``params["layers"]`` is a plain list in layer order (``params_from_jax``
maps one onto the other) and the forward loops over it.

The cache is ``{"k": (L, B, S, Hkv, D), "v": ...}``: one preallocated
tensor per side, so layer ``i``'s (B, S, Hkv, D) cache is the contiguous
view ``cache["k"][i]`` and decode writes into it in place.

Forward modes:
  * prefill: full sequence, ``return_cache=True`` returns this
             sequence's k/v as ``{"k": (L, B, T, Hkv, D), "v": ...}``
  * decode:  T == 1 step against ``cache`` / ``cache_len``
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
# Init (same distributions as repro.models.model.init_params)
# --------------------------------------------------------------------------- #
def _normal(generator: torch.Generator, shape, std: float, dtype,
            device) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device)
    return x.mul_(std).to(device)


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def _init_block(cfg: ModelConfig, generator, dtype, device) -> Params:
    d, hq, hkv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim, cfg.d_ff)
    std = d ** -0.5
    core = {
        "wq": _normal(generator, (d, hq * hd), std, dtype, device),
        "wk": _normal(generator, (d, hkv * hd), std, dtype, device),
        "wv": _normal(generator, (d, hkv * hd), std, dtype, device),
        "wo": _normal(generator, (hq * hd, d), std, dtype, device),
    }
    if cfg.qkv_bias:
        core["bq"] = _zeros((hq * hd,), dtype, device)
        core["bk"] = _zeros((hkv * hd,), dtype, device)
        core["bv"] = _zeros((hkv * hd,), dtype, device)
    ffn = {
        "w_gate": _normal(generator, (d, f), std, dtype, device),
        "w_up": _normal(generator, (d, f), std, dtype, device),
        "w_down": _normal(generator, (f, d), f ** -0.5, dtype, device),
    }
    return {"norm1": {"scale": _zeros((d,), dtype, device)}, "core": core,
            "norm2": {"scale": _zeros((d,), dtype, device)}, "ffn": ffn}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Params:
    """Random weights drawn on ``generator``'s device, placed on
    ``device``.  The draws differ from ``jax.random``'s; a test that needs
    both packages on one set of weights uses ``params_from_jax``."""
    L.check_supported(cfg)
    params: Params = {
        "embed": _normal(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                         dtype, device),
        "final_norm": {"scale": _zeros((cfg.d_model,), dtype, device)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(generator, (cfg.d_model, cfg.vocab_size),
                                    0.02, dtype, device)
    params["layers"] = [_init_block(cfg, generator, dtype, device)
                        for _ in range(cfg.num_layers)]
    return params


# --------------------------------------------------------------------------- #
# Cache
# --------------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda") -> Params:
    L.check_supported(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": _zeros(shape, dtype, device), "v": _zeros(shape, dtype, device)}


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #
def _apply_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                 positions: torch.Tensor, layer_cache: Optional[Params],
                 cache_len: Optional[torch.Tensor], return_cache: bool
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    h = L.rms_norm(bp["norm1"], x, cfg.norm_eps)
    core, new_cache = L.attention_block(
        bp["core"], cfg, h, positions, layer_cache=layer_cache,
        cache_len=cache_len, return_cache=return_cache)
    x = x + core
    h = L.rms_norm(bp["norm2"], x, cfg.norm_eps)
    return x + L.mlp_block(bp["ffn"], h), new_cache


def forward(
    params: Params,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    *,
    cache: Optional[Params] = None,
    cache_len: Optional[torch.Tensor] = None,   # (B,) context so far
    return_cache: bool = False,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (logits, new_cache).

    decode:  batch["tokens"] has T == 1 and ``cache``/``cache_len`` given;
             the cache is updated in place and returned.
    prefill: full sequence + return_cache=True.
    """
    L.check_supported(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    B, T = tokens.shape
    decoding = cache is not None and T == 1

    if "positions" in batch:
        positions = batch["positions"]
    elif decoding:
        positions = cache_len[:, None]
    else:
        positions = torch.arange(T, device=x.device).expand(B, T)

    ks, vs = [], []
    for i, bp in enumerate(params["layers"]):
        lc = ({"k": cache["k"][i], "v": cache["v"][i]} if decoding else None)
        x, nc = _apply_block(cfg, bp, x, positions, lc, cache_len,
                             return_cache)
        if return_cache and not decoding:
            ks.append(nc["k"])
            vs.append(nc["v"])

    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = L.soft_cap(x @ head, cfg.logit_soft_cap)

    if decoding:
        return logits, cache
    if return_cache:
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}
    return logits, None
