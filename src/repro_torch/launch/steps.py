"""Builders for the distributed step functions (train / prefill / decode)
(``repro.launch.steps``), on ``torch.distributed``.

Each builder returns ``(step_fn, args, placements)``: the step, its
arguments as DTensors of meta tensors (shapes only, each rank's shard;
what the dry run runs the step on), and their placements (one tuple of
DTensor placements per tensor, in the arguments' structure).  The same
step runs on real arguments of the same structure: ``place_params`` and
``place_batch`` make them from tensors every rank holds whole (the
placements of ``param_pspecs`` / ``batch_pspecs``), ``init_opt_state``
the optimizer's.  The train step updates its parameters and optimizer
state in place (the reference donates them); the decode step updates its
cache in place (the reference donates it).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.input_specs import InputShape, batch_specs
from repro_torch.models import forward, init_cache, init_params
from repro_torch.models import shardings as sh
from repro_torch.models.layers import MeshInfo
from repro_torch.models.spmd import P, to_placements
from repro_torch.params import tree_leaves
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.train_loop import make_train_step


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16):
    """The port's ``init_params`` on ``device="meta"``: shapes only."""
    return init_params(cfg, None, dtype, "meta")


def place_params(cfg: ModelConfig, params: Any, mi: MeshInfo) -> Any:
    """Parameters (whole on every rank) as DTensors at ``param_pspecs``."""
    return sh.place_tree(params, sh.param_pspecs(cfg, params, mi), mi.mesh)


def place_batch(cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                mi: MeshInfo) -> Dict[str, Any]:
    return sh.place_tree(batch, sh.batch_pspecs(cfg, batch, mi,
                                                bool(mi.batch_axes)),
                         mi.mesh)


def place_cache(cfg: ModelConfig, cache: Any, mi: MeshInfo) -> Any:
    return sh.place_tree(cache, sh.cache_pspecs(cfg, cache, mi,
                                                bool(mi.batch_axes)),
                         mi.mesh)


def init_opt_state(cfg: ModelConfig, params: Any,
                   mi: MeshInfo) -> AdamWState:
    """``AdamW.init`` for DTensor parameters: f32 zeros at
    ``opt_state_pspecs`` (ZeRO-1: the batch axes shard the moments
    further), allocated shard by shard."""
    from torch.distributed.tensor import DTensor
    specs = sh.spec_leaves(sh.opt_state_pspecs(cfg, params, mi))

    def zeros(p, spec):
        pl = to_placements(spec, mi.mesh)
        shape = list(p.shape)
        for mdim, x in enumerate(pl):
            if hasattr(x, "dim"):
                shape[x.dim] //= mi.mesh.shape[mdim]
        local = torch.zeros(shape, dtype=torch.float32,
                            device=p.to_local().device)
        return DTensor.from_local(local, mi.mesh, pl, run_check=False,
                                  shape=p.shape,
                                  stride=torch.empty(
                                      p.shape, device="meta").stride())
    m = [zeros(p, s) for p, s in zip(tree_leaves(params), specs)]
    return AdamWState(step=0, m=m, v=[zeros(p, s) for p, s in
                                      zip(tree_leaves(params), specs)])


def _placements_of(tree):
    if isinstance(tree, dict):
        return {k: _placements_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "placements"):
        return type(tree)(_placements_of(v) for v in tree)
    return tuple(tree.placements) if hasattr(tree, "placements") else None


# --------------------------------------------------------------------------- #
def build_train_step(cfg: ModelConfig, mi: MeshInfo, shape: InputShape,
                     dtype=torch.bfloat16,
                     optimizer: Optional[AdamW] = None):
    """``training.train_loop.make_train_step`` on ``mi``, the step that
    ``train(mi=...)`` runs (``AdamW()`` unless ``optimizer`` is given),
    with its meta arguments and their placements."""
    train_step = make_train_step(cfg, optimizer or AdamW(), mi)
    p = place_params(cfg, abstract_params(cfg, dtype), mi)
    o = init_opt_state(cfg, p, mi)
    b = place_batch(cfg, batch_specs(cfg, shape, act_dtype=dtype), mi)
    args = (p, o, b)
    pl = (_placements_of(p), AdamWState(step=None, m=_placements_of(o.m),
                                        v=_placements_of(o.v)),
          _placements_of(b))
    return train_step, args, pl


# --------------------------------------------------------------------------- #
def build_prefill_step(cfg: ModelConfig, mi: MeshInfo, shape: InputShape,
                       dtype=torch.bfloat16):
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, cache = forward(params, cfg, batch, mi=mi,
                                    return_cache=True)
        return logits[:, -1], cache

    p = place_params(cfg, abstract_params(cfg, dtype), mi)
    b = place_batch(cfg, batch_specs(cfg, shape, act_dtype=dtype), mi)
    return prefill_step, (p, b), (_placements_of(p), _placements_of(b))


# --------------------------------------------------------------------------- #
def build_decode_step(cfg: ModelConfig, mi: MeshInfo, shape: InputShape,
                      dtype=torch.bfloat16):
    B, S = shape.global_batch, shape.seq_len

    def decode_step(params, cache, tokens, cache_len):
        with torch.no_grad():
            logits, cache = forward(params, cfg, {"tokens": tokens}, mi=mi,
                                    cache=cache, cache_len=cache_len)
        return logits[:, 0], cache

    p = place_params(cfg, abstract_params(cfg, dtype), mi)
    c = place_cache(cfg, init_cache(cfg, B, S, dtype, "meta"), mi)
    bspec = mi.batch_axes or None
    t = sh.place_tree(torch.empty((B, 1), dtype=torch.int32, device="meta"),
                      P(bspec, None), mi.mesh)
    lens = sh.place_tree(torch.empty((B,), dtype=torch.int32,
                                     device="meta"), P(bspec), mi.mesh)
    args = (p, c, t, lens)
    return decode_step, args, tuple(_placements_of(a) for a in args)
