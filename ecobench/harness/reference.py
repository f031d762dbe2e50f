"""The plain reference: the decoder's forward pass in float32 in plain
PyTorch, from the benchmark's weights and the configuration file's widths.

It follows the published models (Qwen2, ChatGLM3): token embedding;
per layer an RMSNorm, attention with q/k/v biases, rotary embeddings on
the first ``rope_dims`` of each head (ChatGLM3: half of it), grouped
key/value heads and a causal softmax, the output projection and the
residual; an RMSNorm, the SwiGLU and the residual; a final RMSNorm and
the untied head.  One departure, shared with the program: the rotary
pairs dimension i with i + rope_dims / 2 (the "rotate half" layout of
Qwen2), where ChatGLM3 pairs neighbours; with random weights that is a
fixed permutation of the q/k projections' columns.

``control=True`` computes every product (the projections, q.k and p.v,
the head) on operands rounded to float8 e4m3 with a scale per row of the
left operand and per column of the right: the precision below the
configuration's bfloat16, the step a later change could take.

The layers run in order over all sequences at once, each layer's weights
cast to float32 once, the attention in blocks of query rows, the head at
the asked positions only: it fits beside nothing else on the card.  It
imports nothing of the program.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from ecobench.harness.model import Model

Q_ROWS = 1024           # query rows of one attention block
FP8_MAX = 448.0         # largest finite float8 e4m3fn


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax of the slice onto 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(a: torch.Tensor, b: torch.Tensor, control: bool) -> torch.Tensor:
    """a (..., k) @ b (k, n); under the control ``b`` is rounded already
    (``logits_at`` rounds each weight once)."""
    return (fp8(a, -1) if control else a) @ b


def rms_norm(x: torch.Tensor, offset: torch.Tensor, eps: float):
    """RMSNorm with weight 1 + offset (the file stores the offset)."""
    w = 1.0 + offset.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, m: Model) -> torch.Tensor:
    """x (T, H, D) at positions 0..T-1; angles in float64."""
    n = m.rope_dims // 2
    T = x.shape[0]
    inv = 1.0 / (m.rope_theta ** (torch.arange(n, dtype=torch.float64,
                                                device=x.device) / n))
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :n], x[..., n:2 * n]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                      x[..., 2 * n:]], dim=-1)


def attention(q, k, v, m: Model, control: bool) -> torch.Tensor:
    """Causal attention of one sequence: q (T, Hq, D), k, v (T, Hkv, D)
    -> (T, Hq * D), in blocks of ``Q_ROWS`` query rows."""
    T, D = q.shape[0], m.head_dim
    G = m.group
    kh = k.permute(1, 2, 0)                      # (Hkv, D, T)
    vh = v.permute(1, 0, 2)                      # (Hkv, T, D)
    if control:
        kh, vh = fp8(kh, 1), fp8(vh, 1)
    out = torch.empty((T, m.heads, D), device=q.device)
    for r0 in range(0, T, Q_ROWS):
        r1 = min(T, r0 + Q_ROWS)
        qb = q[r0:r1].reshape(r1 - r0, m.kv_heads, G, D).permute(1, 0, 2, 3)
        qb = qb.reshape(m.kv_heads, (r1 - r0) * G, D)     # rows by head
        if control:
            qb = fp8(qb, -1)
        s = (qb @ kh[:, :, :r1]) * D ** -0.5                # (Hkv, rows, r1)
        pos = torch.arange(r0, r1, device=q.device).repeat_interleave(G)
        mask = torch.arange(r1, device=q.device)[None, :] > pos[:, None]
        s = s.masked_fill(mask[None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        if control:
            p = fp8(p, -1)
        o = p @ vh[:, :r1]                                  # (Hkv, rows, D)
        out[r0:r1] = o.reshape(m.kv_heads, r1 - r0, G, D).permute(
            1, 0, 2, 3).reshape(r1 - r0, m.heads, D)
    return out.reshape(T, m.heads * D)


def layer(x: torch.Tensor, lw: dict, m: Model, control: bool):
    """One decoder layer on one sequence's (T, d) float32 hidden states."""
    T = x.shape[0]
    hd = m.head_dim
    h = rms_norm(x, lw["attn_norm"], m.norm_eps)
    q = _mm(h, lw["wq"], control)
    k = _mm(h, lw["wk"], control)
    v = _mm(h, lw["wv"], control)
    if m.qkv_bias:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    q = rope(q.view(T, m.heads, hd), m)
    k = rope(k.view(T, m.kv_heads, hd), m)
    v = v.view(T, m.kv_heads, hd)
    x = x + _mm(attention(q, k, v, m, control), lw["wo"], control)
    h = rms_norm(x, lw["mlp_norm"], m.norm_eps)
    g = F.silu(_mm(h, lw["w_gate"], control)) * _mm(h, lw["w_up"], control)
    return x + _mm(g, lw["w_down"], control)


def logits_at(w: dict, m: Model, seqs: Sequence[Sequence[int]],
              rows: Sequence[Sequence[int]],
              control: bool = False) -> List[torch.Tensor]:
    """For each token sequence, the float32 logits (len(rows[i]), vocab) at
    its positions ``rows[i]``.  ``w`` holds the weights in any dtype; each
    leaf is cast to float32 when its layer runs."""
    device = w["embed"].device

    def f32(t):
        return t.to(device=device, dtype=torch.float32)

    def weight(t):                      # a matrix (in, out) of a product
        t = f32(t)
        return fp8(t, 0) if control else t

    emb = w["embed"]
    xs = [f32(emb[torch.as_tensor(list(s), device=emb.device)])
          for s in seqs]
    for lw in w["layers"]:
        lw32 = {k: weight(t) if t.ndim == 2 else f32(t)
                for k, t in lw.items()}
        xs = [layer(x, lw32, m, control) for x in xs]
        del lw32
    head = weight(w["lm_head"])
    out = []
    for x, r in zip(xs, rows):
        h = rms_norm(x[torch.as_tensor(list(r), device=device)],
                     w["final_norm"].to(device), m.norm_eps)
        out.append(_mm(h, head, control))
    return out
