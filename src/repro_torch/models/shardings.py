"""Partition-spec rules for params / optimizer state / caches / batches
(``repro.models.shardings`` on ``torch.distributed``).

Megatron-style tensor parallelism over the ``model`` axis; batch over the
(``pod``,) ``data`` axes.  The rules are the reference's, behind the same
names, applied to the port's trees: one dict per layer under
``params["layers"]`` (a reference leaf under ``layers_scan`` is the same
spec with its leading None dropped), and caches that stack each block
kind's layers on a leading axis (always None).  ``fit_spec`` replicates a
dim whose axes do not divide it, where GSPMD would pad (40 heads on a
16-way axis); the model then replicates those heads
(``repro_torch.models.layers.split_heads``).  ``to_placements`` turns a
spec into DTensor placements (``to_named``'s counterpart).

The ``fsdp`` variant (``MeshInfo.fsdp_params``).  The reference stacks a
pattern position's layers on a leading axis and shards the first
still-replicated dim of that stacked leaf over the batch axes, which for
most leaves is the layer axis itself (llama3-8b's ``wq`` (32, 4096, 4096)
at 16x16: ``P('data', None, 'model')``), each device holding whole
layers.  The port keeps one tensor per layer, so it cannot place whole
layers on devices without giving every layer a different placement.  It
shards each layer instead: a leaf whose stacked counterpart the reference
shards (its stacked size, the layer's size times the cycles, at least
2^20 elements) gets the batch axes on its own first still-replicated dim
that they divide.  Each device then holds the same bytes of every layer
group as under the reference's placement (the layer axis or a per-layer
dim: either way 1 / (batch axes' size) of the group), and each layer's
weights are gathered where that layer runs.  The optimizer state's
ZeRO-1 widening skips a leaf whose spec names the batch axes already.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MeshInfo
from repro_torch.models.spmd import P, PartitionSpec, spec_axes, \
    to_placements  # noqa: F401  (re-exported)

UP = {"wq", "wk", "wv", "w_gate", "w_up", "w_x", "w_in_gate", "w_rec_gate",
      "w_r", "w_k", "w_v", "w_g", "w_in", "decay_lora_b"}
DOWN = {"wo", "w_down", "w_out", "w_o"}


# leaf name -> spec builder(model_axis M) ------------------------------------
def _param_spec(path: Tuple[str, ...], leaf, M: str) -> P:
    name = path[-1]
    ndim = leaf.ndim - (1 if any(p == "layers_scan" for p in path) else 0)
    if name == "embed":
        return P(M, None)
    if name == "lm_head":
        return P(None, M)
    if name == "frontend":
        return P(None, None)
    if name == "router":
        return P()
    if name in UP:
        if ndim == 3:                # moe expert weights (E, d, f)
            return P(M, None, None)
        return P(None, M)
    if name in DOWN:
        if ndim == 3:                # (E, f, d)
            return P(M, None, None)
        return P(M, None)
    if name in ("bq", "bk", "bv", "lambda", "decay_base"):
        return P(M)
    if name == "conv_w":
        return P(None, M)
    if name == "bonus_u":
        return P(M, None)
    # norms, mu, lora_a, scales: replicated
    return P()


def _pad_scan_dim(path: Tuple[str, ...], spec: P) -> P:
    """Stacked params have a leading layer dim -> prepend None."""
    if any(p == "layers_scan" for p in path):
        return P(None, *spec)
    return spec


def _size(mi: MeshInfo, axes) -> int:
    n = 1
    for a in axes:
        n *= mi.axis_size(a)
    return n


def fit_spec(spec: P, shape, mi: MeshInfo) -> P:
    """Drop (replicate) axes whose mesh size does not divide the dim."""
    if mi.mesh is None:
        return P()
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, parts):
        if ax is None:
            out.append(None)
            continue
        out.append(ax if dim % _size(mi, spec_axes(ax)) == 0 else None)
    return P(*out)


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``jax.tree_util.tree_map_with_path`` over dicts, lists and tuples,
    the path as a tuple of key names (list indices as strings)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _layer_cycles(cfg: ModelConfig, path: Tuple[str, ...]) -> int:
    """How many layers the reference stacks with this per-layer leaf: the
    cycles of the block pattern for a layer of ``layers_scan``, 1 for a
    layer of ``layers_tail`` or a leaf outside the layers."""
    if len(path) < 2 or path[0] != "layers":
        return 1
    plen = len(cfg.block_pattern)
    n_full = cfg.num_layers // plen
    return n_full if int(path[1]) < n_full * plen else 1


def param_pspecs(cfg: ModelConfig, params: Any, mi: MeshInfo) -> Any:
    M = mi.model_axis
    # FSDP sharding uses the mesh's non-model axes even when the batch
    # itself is too small to shard (e.g. batch=1 long-context decode)
    data_axes = mi.batch_axes
    if mi.fsdp_params and not data_axes and mi.mesh is not None:
        data_axes = tuple(a for a in mi.mesh.mesh_dim_names if a != M)

    def fn(path, leaf):
        spec = fit_spec(_pad_scan_dim(path, _param_spec(path, leaf, M)),
                        leaf.shape, mi)
        stacked = leaf.numel() * _layer_cycles(cfg, path)
        if mi.fsdp_params and data_axes and stacked >= 1 << 20:
            # FSDP-style: shard the first still-replicated big dim over
            # the batch axes (DTensor all-gathers the shard before use)
            parts = list(spec) + [None] * (leaf.ndim - len(spec))
            n = _size(mi, data_axes)
            for i, (dim, s) in enumerate(zip(leaf.shape, parts)):
                if s is None and dim % n == 0 and dim >= n:
                    parts[i] = data_axes
                    break
            spec = P(*parts)
        return spec

    return tree_map_with_path(fn, params)


def opt_state_pspecs(cfg: ModelConfig, params: Any, mi: MeshInfo,
                     zero1: bool = True) -> Any:
    """Adam m/v: param sharding + ZeRO-1-style extra sharding of the first
    still-replicated dim over the data axis (needed for 32B+ models)."""
    base = param_pspecs(cfg, params, mi)
    if not zero1 or not mi.batch_axes:
        return base
    data_axes = mi.batch_axes

    def widen(path, leaf):
        spec = base_at(base, path)
        parts = list(spec) + [None] * (leaf.ndim - len(spec))
        if any(set(spec_axes(s)) & set(data_axes) for s in parts):
            return P(*parts)          # fsdp: the batch axes are in use
        for i, (dim, s) in enumerate(zip(leaf.shape, parts)):
            if s is None and dim % _size(mi, data_axes) == 0 and dim >= 1024:
                parts[i] = data_axes
                break
        return P(*parts)

    return tree_map_with_path(widen, params)


def base_at(tree, path):
    node = tree
    for p in path:
        node = node[int(p)] if isinstance(node, (list, tuple)) else node[p]
    return node


def cache_pspecs(cfg: ModelConfig, cache: Any, mi: MeshInfo,
                 shard_batch: bool) -> Any:
    """KV / state caches: batch over data axes, heads over model axis.
    The port's cache keys (``repro_torch.models.model.CACHE_KEYS``) each
    stack their kind's layers on a leading axis (the reference's ``scan``
    layout; its ``local_k``/``local_v`` are the reference's ``k``/``v`` of
    a LOCAL_ATTN position)."""
    B = mi.batch_axes if shard_batch else None
    M = mi.model_axis

    def fn(path, leaf):
        name = path[-1]
        if name in ("k", "v", "local_k", "local_v"):   # (B, S, kv, hd)
            spec = (P(B, None, None, M) if mi.kv_shard == "head_dim"
                    else P(B, None, M, None))
        elif name == "state":                     # (B, H, hd, hd)
            spec = P(B, M, None, None)
        elif name in ("conv", "h", "shift"):      # (B, ..., d) channel-wise
            spec = P(B, None, M) if leaf.ndim - 1 == 3 else P(B, M)
        else:  # pragma: no cover
            spec = P()
        return fit_spec(P(None, *spec), leaf.shape, mi)

    return tree_map_with_path(fn, cache)


def batch_pspecs(cfg: ModelConfig, batch: Dict[str, Any], mi: MeshInfo,
                 shard_batch: bool) -> Dict[str, Any]:
    B = mi.batch_axes if shard_batch else None
    out = {}
    for k, v in batch.items():
        out[k] = fit_spec(P(B, *([None] * (v.ndim - 1))), v.shape, mi)
    return out


def spec_leaves(tree) -> list:
    """The specs of a spec tree in ``params.tree_leaves`` order (dict keys
    sorted; a ``PartitionSpec`` is a leaf, not a tuple)."""
    if isinstance(tree, PartitionSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    return [x for v in tree for x in spec_leaves(v)]


def place_tree(tree, specs, mesh) -> Any:
    """Each tensor of ``tree`` (held whole on every rank) as a DTensor at
    its spec in ``specs``, each rank keeping its own shard."""
    from repro_torch.models.spmd import place
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, s, mesh) for v, s in zip(tree, specs))
    return place(tree, specs, mesh)
