"""AdamW as ``repro.training.optimizer.AdamW`` computes it (not
``torch.optim.AdamW``): the gradients clipped to a global f32 norm, bias
correction by ``b ** step`` in f32, weight decay on every leaf, m and v
kept in f32, the result cast back to each parameter's dtype.

The reference is functional; here ``update`` writes the new parameters,
m and v into their tensors in place (a training step on the card holds
parameters, gradients, m and v once, not twice), and reads nothing back
to the host: the clip factor stays on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.params import tree_leaves


class AdamWState(NamedTuple):
    step: int                    # updates taken
    m: List[torch.Tensor]        # f32, one per leaf of the parameters
    v: List[torch.Tensor]        # f32


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Any) -> AdamWState:
        m = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(params)]
        return AdamWState(step=0, m=m, v=[x.clone() for x in m])

    def update(self, grads: Any, state: AdamWState,
               params: Any) -> Tuple[Any, AdamWState]:
        """One step, in place; returns ``(params, state)``.  ``grads`` has
        the parameters' structure (a missing gradient is a zero one)."""
        leaves = tree_leaves(params)
        gl = tree_leaves(grads)
        if len(gl) != len(leaves) or len(state.m) != len(leaves):
            raise ValueError(f"{len(gl)} gradients and {len(state.m)} "
                             f"moments for {len(leaves)} parameters")
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in gl))
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-12), max=1.0)
        step = state.step + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(step))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(step))
        with torch.no_grad():
            for g, m, v, p in zip(gl, state.m, state.v, leaves):
                # the reference's expressions and roundings, on temporaries
                # updated in place where that rounds the same
                g = g.float() * scale
                m.mul_(self.b1).add_(g * (1 - self.b1))
                v.mul_(self.b2).add_(g.square_().mul_(1 - self.b2))
                delta = m / bc1
                delta.div_((v / bc2).sqrt_().add_(self.eps))
                delta.add_(p.float() * self.weight_decay)
                p.copy_((p.float() - delta.mul_(self.lr)).to(p.dtype))
        return params, AdamWState(step=step, m=state.m, v=state.v)
