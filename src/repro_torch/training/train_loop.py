"""Training loop: ``repro.training.train_loop.train`` in PyTorch, on one
device (the card unless the caller asks for the CPU), or on a mesh.

``make_train_step(cfg, optimizer)`` is the reference's jitted ``step_fn``:
loss and gradients of ``make_loss_fn`` (each block rematerialised in the
backward, as the reference's ``jax.checkpoint`` does), then the
optimizer's update, in place.  Unused parameters (an encoder's token
embedding) get zero gradients, as ``jax.grad`` gives them.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import init_params, make_loss_fn
from repro_torch.models.layers import MeshInfo
from repro_torch.params import tree_leaves, tree_unflatten
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import AdamW, AdamWState

Params = Dict[str, Any]


def loss_and_grads(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor],
                   mi: MeshInfo = MeshInfo()
                   ) -> Tuple[torch.Tensor, Params]:
    """``jax.value_and_grad(make_loss_fn(cfg, mi))(params, batch)``: the
    loss and a tree of gradients shaped like ``params``.  On a mesh each
    gradient is placed as its parameter (the batch axes' partial sums
    all-reduced)."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = make_loss_fn(cfg, mi)(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    if mi.mesh is not None:
        grads = [g if tuple(g.placements) == tuple(p.placements)
                 else g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(params, iter(grads))


def make_train_step(cfg: ModelConfig, optimizer: AdamW,
                    mi: MeshInfo = MeshInfo()
                    ) -> Callable[[Params, AdamWState, Dict],
                                  Tuple[Params, AdamWState, torch.Tensor]]:
    def train_step(params: Params, opt_state: AdamWState,
                   batch: Dict[str, torch.Tensor]):
        loss, grads = loss_and_grads(cfg, params, batch, mi)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def to_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device`` as the reference's ``jnp.asarray``
    leaves it, whatever the model's dtype: float arrays (frames, patches)
    in their own dtype (float64 as f32, as jnp makes it without x64), so
    a bf16 model fed f32 frames computes in f32 from its frontend on;
    integer arrays (tokens, labels) as int64, torch's index type."""
    out = {}
    for key, val in batch.items():
        t = torch.as_tensor(np.asarray(val))
        if not torch.is_floating_point(t):
            t = t.long()
        elif t.dtype == torch.float64:
            t = t.float()
        out[key] = t.to(device)
    return out


def train(
    cfg: ModelConfig,
    batches: Iterator[Dict],
    *,
    steps: int = 200,
    optimizer: AdamW = AdamW(lr=1e-3),
    dtype=torch.float32,
    seed: int = 0,
    log_every: int = 10,
    checkpoint_path: Optional[str] = None,
    log_fn: Callable[[str], None] = print,
    device="cuda",
    mi: MeshInfo = MeshInfo(),
):
    """Returns (params, losses).  Parameters from the port's
    ``init_params`` on a generator seeded with ``seed`` on ``device``.

    On a mesh (``mi.mesh``: every rank runs ``train`` on the same seed and
    batches) the parameters become DTensors at ``param_pspecs``, the
    AdamW moments at ``opt_state_pspecs`` (ZeRO-1 over the batch axes),
    each batch is split over the batch axes, and the step is
    ``launch.steps.build_train_step``'s: DTensor's propagation through the
    model, the kernels in local regions, each gradient all-reduced to its
    parameter's placement, the update on the shards in place.  The losses
    are the global batch's; the returned parameters are DTensors."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "train: device is 'cuda' but no CUDA device is available; pass "
            "device='cpu' to run the plain versions on the CPU")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gen, dtype, dev)
    if mi.mesh is None:
        opt_state = optimizer.init(params)
    else:
        from repro_torch.launch.steps import (init_opt_state, place_batch,
                                              place_params)
        params = place_params(cfg, params, mi)
        opt_state = init_opt_state(cfg, params, mi)
    step_fn = make_train_step(cfg, optimizer, mi)

    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        batch = to_batch(next(batches), dev)
        if mi.mesh is not None:
            batch = place_batch(cfg, batch, mi)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if mi.mesh is not None:
            loss = loss.full_tensor()
        losses.append(float(loss))
        if step % log_every == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            log_fn(f"step {step:5d}  loss {losses[-1]:.4f}  "
                   f"({dt / (step + 1):.3f}s/step)")
    if checkpoint_path:
        saved = params
        if mi.mesh is not None:          # the whole tensors
            from repro_torch.models.spmd import full
            saved = tree_unflatten(params, iter(
                [full(p).detach() for p in tree_leaves(params)]))
        save_checkpoint(checkpoint_path, saved, cfg, step=steps)
    return params, losses
