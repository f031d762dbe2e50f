"""The dense decode step replayed as CUDA graphs split at its attention
kernel.

A decode step of N attention layers is N + 1 pieces, each the work
between two calls of ``decode_attention``:

* piece 0: the embedding and layer 0 up to its kernel;
* piece i: layer i - 1 from its kernel's output on (output projection,
  residual, FFN), then layer i up to its kernel (norm, projections, qkv
  bias, qk-norm, rotary, the new k/v written into the cache ring);
* piece N: the last layer's rest, the final norm, the head, the argmax
  and the live slots' new tokens written into the engine's tokens.

On a CUDA device each piece is captured once as a CUDA graph (all in one
memory pool) and replayed every step; the kernel runs eagerly between
them, called as ``repro_torch.models.layers.decode_attention_op(q,
k_cache, v_cache, lengths)``, looked up at each call, so that whatever
wraps that name sees every call.  Its output is copied into the next
piece's input.  The pieces are ``models.model.block_decode_in`` /
``block_decode_out``, built on ``layers.attention_decode_in`` /
``attention_decode_out``, the halves the eager ``forward`` decode runs
too (in ``layers.attention_block``).
On the CPU the pieces run eagerly, one after the other.

The first step runs the pieces eagerly on a side stream (warming cuBLAS
and the allocator there), then captures them on it; every later step
replays.  The slot lengths and live flags reach the graphs through
static device buffers, filled from pinned host copies at each step.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import ATTN, LOCAL_ATTN, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.layers import MeshInfo


def graphs_apply(cfg: ModelConfig, device, mi: MeshInfo = MeshInfo()
                 ) -> bool:
    """Whether an engine replays its decode step as graphs: on a CUDA
    device, without a mesh, where every layer is attention (``ATTN`` or
    ``LOCAL_ATTN``) with a dense FFN.  MoE (capacity routing), RWKV-6 and
    RG-LRU layers keep the eager ``forward`` step."""
    return (torch.device(device).type == "cuda" and mi.mesh is None
            and not cfg.is_moe
            and set(M.layer_kinds(cfg)) <= {ATTN, LOCAL_ATTN})


def next_tokens(logits: torch.Tensor, live: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """The step's argmax (B, 1), written into ``tokens`` in place for the
    live slots only: a free slot decodes its stale token again."""
    new = logits[:, 0].argmax(-1, keepdim=True)
    tokens.copy_(torch.where(live[:, None], new, tokens))
    return new


class DecodeGraphs:
    """One engine's decode step in pieces (module docstring) over its
    ``params``, ``cache`` and ``tokens`` (B, 1), which it holds: a new
    set of weights or a new cache takes a new ``DecodeGraphs``."""

    def __init__(self, params, cfg: ModelConfig, cache, tokens: torch.Tensor):
        self.params, self.cfg, self.tokens = params, cfg, tokens
        dev = tokens.device
        B = tokens.shape[0]
        self.capture = dev.type == "cuda"
        self.lengths = torch.zeros(B, dtype=torch.int32, device=dev)
        self.live = torch.zeros(B, dtype=torch.bool, device=dev)
        self._host = (torch.zeros(B, dtype=torch.int32,
                                  pin_memory=self.capture),
                      torch.zeros(B, dtype=torch.bool,
                                  pin_memory=self.capture))
        self.positions = M.decode_positions(cfg, self.lengths)
        self.blocks = [(bp, kind, {bk: cache[ck][j] for bk, ck
                                   in M.CACHE_KEYS[kind].items()})
                       for bp, (kind, j) in zip(params["layers"],
                                                M._cache_index(cfg))]
        self.x = self.attn = None       # the next piece's inputs
        self.graphs = []
        self.outs = []                  # each piece's outputs, when captured
        self._stream = torch.cuda.Stream(dev) if self.capture else None

    @property
    def captured(self) -> bool:
        return bool(self.graphs)

    def _piece(self, i: int):
        """Piece ``i``: (x, q, valid) for i < N, (logits, new) for i = N."""
        cfg, n = self.cfg, len(self.blocks)
        if i == 0:
            x = M._embed_inputs(self.params, cfg, {"tokens": self.tokens})
        else:
            bp, kind, _ = self.blocks[i - 1]
            x = M.block_decode_out(cfg, kind, bp, self.x, self.attn)
        if i < n:
            bp, _, lc = self.blocks[i]
            q, valid = M.block_decode_in(cfg, bp, x, self.positions, lc,
                                         self.lengths)
            return x, q, valid
        logits = M.head_logits(self.params, cfg, x)
        return logits, next_tokens(logits, self.live, self.tokens)

    def _attend(self, i: int, q, valid) -> torch.Tensor:
        lc = self.blocks[i][2]
        return L.decode_attention_op(q, lc["k"], lc["v"], valid)

    def _eager(self):
        n = len(self.blocks)
        for i in range(n):
            self.x, q, valid = self._piece(i)
            self.attn = self._attend(i, q, valid)
        return self._piece(n)

    def _capture(self) -> None:
        n = len(self.blocks)
        torch.cuda.synchronize(self.tokens.device)
        pool = torch.cuda.graph_pool_handle()
        self.attn = torch.empty_like(self.attn)      # filled before a replay
        with torch.cuda.stream(self._stream):
            for i in range(n + 1):
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    out = self._piece(i)
                finally:
                    g.capture_end()
                if i < n:
                    self.x = out[0]
                self.graphs.append(g)
                self.outs.append(out)

    def _replay(self):
        n = len(self.blocks)
        for i, (g, out) in enumerate(zip(self.graphs, self.outs)):
            g.replay()
            if i < n:
                self.attn.copy_(self._attend(i, out[1], out[2]))
        return self.outs[n]

    def step(self, lengths: np.ndarray, live: np.ndarray
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode step over every slot at these context lengths (B,)
        int32, the ``live`` (B,) slots taking their new token.  Returns
        (logits (B, 1, V), new tokens (B, 1)); once captured, the same
        tensors every step, valid until the next."""
        hl, hv = self._host
        hl.copy_(torch.from_numpy(lengths))
        hv.copy_(torch.from_numpy(live))
        self.lengths.copy_(hl, non_blocking=True)
        self.live.copy_(hv, non_blocking=True)
        if self.graphs:
            return self._replay()
        if not self.capture:
            return self._eager()
        cur = torch.cuda.current_stream(self.tokens.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = self._eager()
        self._capture()
        cur.wait_stream(self._stream)
        return out
