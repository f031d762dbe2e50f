"""Checkpoints in the JAX package's npz format, which both packages read:
``<path>.npz`` holds ``leaf_{i}`` in the order of JAX's tree flattening of
the ``repro.models.init_params`` structure (``repro_torch.params.
params_to_jax``: dict keys sorted, ``layers_scan/pos{p}`` stacked over
cycles, then ``layers_tail``), and ``<path>.meta.json`` the step, the
leaf count and the tree structure's string.  ``repro.training.checkpoint.
load_checkpoint(path, like=init_params(...))`` restores what ``save_
checkpoint`` writes here, and ``load_checkpoint`` here restores what the
JAX package saved.  bf16 leaves are written as f32.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.params import (jax_treedef, params_from_jax, params_to_jax,
                                tree_leaves, tree_unflatten)


def _base(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def save_checkpoint(path: str, params: Dict[str, Any], cfg: ModelConfig,
                    step: int = 0) -> None:
    base = _base(path)
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    tree = params_to_jax(params, cfg)
    leaves = tree_leaves(tree)
    np.savez(base + ".npz",
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    with open(base + ".meta.json", "w") as f:
        json.dump({"step": step, "n_leaves": len(leaves),
                   "treedef": jax_treedef(tree)}, f)


def load_checkpoint(path: str, like: Dict[str, Any], cfg: ModelConfig
                    ) -> Tuple[Dict[str, Any], int]:
    """Parameters in the port's layout, on ``like``'s device and in its
    dtype, with shapes checked against ``like``, and the saved step."""
    base = _base(path)
    tree = params_to_jax(like, cfg)
    want = tree_leaves(tree)
    with np.load(base + ".npz") as data:
        leaves = []
        for i, leaf in enumerate(want):
            arr = data[f"leaf_{i}"]
            if arr.shape != leaf.shape:
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} "
                                 f"!= {leaf.shape}")
            leaves.append(arr)
    with open(base + ".meta.json") as f:
        meta = json.load(f)
    ref = tree_leaves(like)[0]
    params = params_from_jax(tree_unflatten(tree, iter(leaves)), cfg,
                             ref.device)
    dtype = ref.dtype
    params = tree_unflatten(params, iter(
        t.to(dtype) if t.dtype != dtype else t
        for t in tree_leaves(params)))
    return params, meta["step"]
