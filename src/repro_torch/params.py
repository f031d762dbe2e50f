"""Weight bridge: the JAX ``init_params`` pytree (as numpy) -> the port's
parameters.

The JAX package stacks the layers of each block-pattern position under
``layers_scan/pos{p}`` with a leading ``n_full`` cycle axis (layer
``c * plen + p``) and keeps the remainder as the ``layers_tail`` tuple
(layer ``n_full * plen + i``; ``repro/models/model.py:63-96``).  The port
keeps one dict per layer in ``params["layers"]``, in layer order, with the
same leaf names and the same (in, out) weight layout.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import check_supported


def to_tensor(a, device="cuda") -> torch.Tensor:
    """numpy (float32, or the ``bfloat16`` numpy dtype JAX exports) ->
    torch, on ``device``."""
    a = np.array(a, order="C")   # a writable copy: jax's arrays are not
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """``tree``: ``jax.tree.map(np.asarray, repro.models.init_params(...))``."""
    check_supported(cfg)
    plen = len(cfg.block_pattern)
    n_full = cfg.num_layers // plen
    layers = [None] * cfg.num_layers
    for p in range(plen):
        stacked = tree["layers_scan"][f"pos{p}"]
        for c in range(n_full):
            layers[c * plen + p] = _map(
                stacked, lambda a, c=c: to_tensor(np.asarray(a)[c], device))
    for i, block in enumerate(tree["layers_tail"]):
        layers[n_full * plen + i] = _map(
            block, lambda a: to_tensor(a, device))
    params = {
        "embed": to_tensor(tree["embed"], device),
        "final_norm": {"scale": to_tensor(tree["final_norm"]["scale"],
                                          device)},
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = to_tensor(tree["lm_head"], device)
    if cfg.frontend_dim:
        params["frontend"] = to_tensor(tree["frontend"], device)
    return params
