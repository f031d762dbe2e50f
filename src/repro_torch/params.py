"""Weight bridge: the JAX ``init_params`` pytree (as numpy) <-> the port's
parameters.

The JAX package stacks the layers of each block-pattern position under
``layers_scan/pos{p}`` with a leading ``n_full`` cycle axis (layer
``c * plen + p``) and keeps the remainder as the ``layers_tail`` tuple
(layer ``n_full * plen + i``; ``repro/models/model.py:63-96``).  The port
keeps one dict per layer in ``params["layers"]``, in layer order, with the
same leaf names and the same (in, out) weight layout.  ``params_to_jax``
is the inverse (numpy, JAX layout); ``cache_from_jax`` /
``cache_to_jax`` map the reference's ``init_cache`` pytree (stacked by
pattern cycle, like the parameters) onto the port's per-kind cache and
back; and ``tree_leaves`` /
``tree_unflatten`` / ``jax_treedef`` re-implement JAX's tree flattening
(dict keys sorted, tuples and lists in order) without importing JAX: for
the checkpoint format both packages read, and to order the port's own
trees (parameters, gradients, optimizer moments).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import check_supported
from repro_torch.models.model import CACHE_KEYS, _block_cache, _cache_index


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


def _layer_slots(cfg: ModelConfig):
    """(layer i's place in the JAX layout: (cycle c, pattern position p) in
    ``scan``/``layers_scan``, or (None, tail index)), (its kind, its index
    among the port's layers of that kind)) for every layer, in order."""
    from repro_torch.models.model import _cache_index
    plen = len(cfg.block_pattern)
    n_scan = cfg.num_layers // plen * plen
    return [(divmod(i, plen) if i < n_scan else (None, i - n_scan), kj)
            for i, kj in enumerate(_cache_index(cfg))]


def cache_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                   device="cuda") -> Dict[str, Any]:
    """``tree``: ``jax.tree.map(np.asarray, repro.models.init_cache(...))``
    (or a cache the reference's forward returned), ``{"scan": {pos{p}:
    {key: (n_full, B, ...)}}, "tail": ({key: (B, ...)}, ...)}``: the port's
    cache, one tensor per key stacking the layers of the kind that uses it
    in layer order (``repro_torch.models.model.CACHE_KEYS``)."""
    check_supported(cfg)
    stacks: Dict[str, list] = {}
    for (c, p), (kind, _) in _layer_slots(cfg):
        block = (tree["tail"][p] if c is None else
                 {k: np.asarray(a)[c]
                  for k, a in tree["scan"][f"pos{p}"].items()})
        for key, ck in CACHE_KEYS[kind].items():
            stacks.setdefault(ck, []).append(np.asarray(block[key]))
    return {ck: to_tensor(np.stack(vals), device)
            for ck, vals in stacks.items()}


def cache_to_jax(cache: Dict[str, Any], cfg: ModelConfig
                 ) -> Dict[str, Any]:
    """The inverse of ``cache_from_jax``: the port's cache as numpy in the
    reference's ``init_cache`` layout."""
    plen = len(cfg.block_pattern)
    n_full = cfg.num_layers // plen
    blocks = [{key: to_numpy(cache[ck][j])
               for key, ck in CACHE_KEYS[kind].items()}
              for _, (kind, j) in _layer_slots(cfg)]
    if n_full:
        scan = {f"pos{p}": {key: np.stack([blocks[c * plen + p][key]
                                           for c in range(n_full)])
                            for key in blocks[p]}
                for p in range(plen)}
    else:       # no whole cycle: the reference keeps empty stacks
        batch = next(iter(cache.values())).shape[1]
        rows = cache["k"].shape[2] if "k" in cache else 0
        scan = {f"pos{p}": {
            key: np.zeros((0,) + shape, np.float32)
            for key, (shape, _) in _block_cache(
                cfg, kind, batch, rows, torch.float32).items()}
            for p, kind in enumerate(cfg.block_pattern)}
    return {"scan": scan, "tail": tuple(blocks[n_full * plen:])}


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host (bf16 widened to f32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def params_to_jax(params: Dict[str, Any], cfg: ModelConfig
                  ) -> Dict[str, Any]:
    """The port's parameters (or a tree of the same shape, such as their
    gradients) as numpy in the JAX ``init_params`` layout: layer
    ``c * plen + p`` stacked as cycle ``c`` of ``layers_scan/pos{p}``, the
    remainder as the ``layers_tail`` tuple."""
    plen = len(cfg.block_pattern)
    n_full = cfg.num_layers // plen
    layers = params["layers"]
    tree = {key: _map(val, to_numpy) for key, val in params.items()
            if key != "layers"}
    tree["layers_scan"] = {
        f"pos{p}": _stack([layers[c * plen + p] for c in range(n_full)])
        for p in range(plen)}
    tree["layers_tail"] = tuple(_map(block, to_numpy)
                                for block in layers[n_full * plen:])
    return tree


def _stack(blocks: List[Dict[str, Any]]):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack([to_numpy(b) for b in blocks])


def tree_leaves(tree) -> List[Any]:
    """The leaves in JAX's flattening order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: Iterator[Any]):
    """``like``'s structure with its leaves taken in ``tree_leaves`` order
    from the iterator ``leaves``."""
    if isinstance(like, dict):
        out = {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(tree_unflatten(v, leaves) for v in like)
    return next(leaves)


def jax_treedef(tree) -> str:
    """``str(jax.tree.structure(tree))`` for a tree of dicts, tuples and
    array leaves."""
    def fmt(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(fmt(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({fmt(tree)})"
