"""Building blocks of the port's decoders, in PyTorch.

Counterparts of ``repro.models.layers`` for the served paths: plain
functions over a params dict and tensors, in the JAX layouts ((B,T,H,D)
activations, (B,S,Hkv,D) caches, weights stored as (in, out)).  The
kernels are reached through the dispatch names of
``repro_torch.kernels.ops``: ``flash_prefill_op`` where JAX calls
``blockwise_attention``, ``decode_attention_op`` where it calls
``decode_attention_jnp``, ``rglru_scan_op`` where it calls
``rglru_scan_jnp``, and ``rwkv6_scan_op`` where it calls
``rwkv6_chunked_jnp``.

Blocks: global and sliding-window causal attention with SwiGLU (dense GQA
decoders, and the local attention of Griffin), bidirectional for an
encoder (hubert-xlarge, whose audio frames come in through its
``frontend`` projection), with the attention
flavours of the dense decoders: qkv bias, per-head q/k RMSNorm (qwen3-4b),
rotary on the full head, on its first half (chatglm3-6b) or in M-RoPE's
three position sections (qwen2-vl-2b); the RG-LRU recurrent block
(recurrentgemma-2b), the RWKV-6 time mix with its squared-ReLU channel
mix (rwkv6-3b), and the capacity-routed mixture of experts on one device
(phi3.5-moe, llama4-scout).  Block kinds or flavours outside these raise
``NotImplementedError``.

Dtypes promote as in jnp: every product of an activation and a weight
goes through ``matmul``, so f32 activations (a bf16 model's f32 frames or
patches) meeting bf16 weights compute in f32, and elementwise ops and
``torch.cat`` promote alike.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, RGLRU, RWKV6,
                                      ModelConfig)
from repro_torch.kernels.ops import (decode_attention_op, flash_prefill_op,
                                     rglru_scan_op, rwkv6_scan_op)

Params = Dict[str, Any]

DECAY_LORA = 64        # rank of the RWKV-6 decay LoRA (layers.py DECAY_LORA)
CONV_WIDTH = 4         # RG-LRU temporal conv (layers.py CONV_WIDTH)
RGLRU_C = 8.0          # RG-LRU decay scale (layers.py RGLRU_C)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every flavour the port does not implement yet."""
    missing = []
    other = set(cfg.block_pattern) - {ATTN, LOCAL_ATTN, RGLRU, RWKV6}
    if other:
        missing.append(f"block kinds {sorted(other)}")
    if cfg.rope not in ("full", "half", "mrope", "none"):
        missing.append(f"rope={cfg.rope!r}")
    if cfg.modality not in ("text", "vision", "audio"):
        missing.append(f"modality={cfg.modality!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing)}")


# --------------------------------------------------------------------------- #
# Small primitives
# --------------------------------------------------------------------------- #
def rms_norm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the dtype ``jnp.matmul`` computes it in, the promotion
    of the two: a bf16 model fed f32 frames or patches runs on in f32, as
    the reference does.  The cast's backward rounds a weight's gradient to
    the weight's dtype, as ``convert_element_type``'s does; where the
    dtypes agree the casts are no-ops."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


# --------------------------------------------------------------------------- #
# Rotary embeddings (full / half / mrope; pairs-first half-split layout,
# not interleaved)
# --------------------------------------------------------------------------- #
def _rope_freqs(theta: float, n_freq: int, device) -> torch.Tensor:
    exponent = torch.arange(0, n_freq, dtype=torch.float32,
                            device=device) / n_freq
    return 1.0 / (theta ** exponent)


def apply_rope(cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (B, T, heads, head_dim); positions: (B, T), or (B, T, 3) for
    mrope.  "half" rotates the first half of head_dim (n_freq = hd/4
    frequencies, the exponent over n_freq) and passes the rest through;
    "mrope" splits the n_freq = hd/2 frequency slots 2:1:1 into
    (temporal, height, width) sections, each turned by its own column of
    positions."""
    if cfg.rope == "none":
        return x
    hd = x.shape[-1]
    n = hd // 4 if cfg.rope == "half" else hd // 2
    freqs = _rope_freqs(cfg.rope_theta, n, x.device)
    pos = positions.float()
    if cfg.rope == "mrope":
        s1 = n // 2
        s2 = (n - s1) // 2
        ang = torch.cat([pos[..., 0:1] * freqs[:s1],
                         pos[..., 1:2] * freqs[s1:s1 + s2],
                         pos[..., 2:3] * freqs[s1 + s2:]], dim=-1)
    else:
        ang = pos[..., None] * freqs                        # (B, T, n)
    ang = ang[:, :, None, :]                                # over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :n], x[..., n:2 * n]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
    if hd > 2 * n:                       # "half": the rest passes through
        rotated = torch.cat([rotated, x[..., 2 * n:]], dim=-1)
    return rotated


# --------------------------------------------------------------------------- #
# Attention block (global or sliding-window; causal, or bidirectional for an
# encoder)
# --------------------------------------------------------------------------- #
def _ring(x: torch.Tensor, window: int) -> torch.Tensor:
    """A prefill's (B, T, ...) k or v as a ``window``-row ring buffer with
    position p at row p % window (``repro.models.layers.attention_block``):
    the trailing window rolled by T % window when window < T; T rows and
    zeros after them when window > T."""
    T = x.shape[1]
    if window < T:
        return torch.roll(x[:, T - window:], T % window, dims=1)
    if window > T:
        pad = x.new_zeros((x.shape[0], window - T) + tuple(x.shape[2:]))
        return torch.cat([x, pad], dim=1)
    return x


def attention_block(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                        # (B, T, d)
    positions: torch.Tensor,                # (B, T) or (B, T, 3) (mrope)
    *,
    window: int = 0,                        # 0 for global
    layer_cache: Optional[Params],          # {"k","v"}: (B, S, Hkv, D)
    cache_len: Optional[torch.Tensor],      # (B,) int tokens already cached
    return_cache: bool,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Prefill (full sequence) or decode (T == 1 with a cache).  Decode
    writes the new k/v into ``layer_cache`` IN PLACE at ring index
    ``cache_len % S`` (JAX returns an updated copy; the port saves the
    cache's memory) and returns the same dict.  With a ``window`` the
    prefill attends over it and returns its k/v ring-ordered in ``window``
    rows, the size of a sliding-window layer's cache (S == window)."""
    B, T, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = matmul(x, params["wq"])
    k = matmul(x, params["wk"])
    v = matmul(x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, T, hq, hd)
    k = k.reshape(B, T, hkv, hd)
    v = v.reshape(B, T, hkv, hd)
    if cfg.qk_norm:
        # per head, over head_dim
        q = rms_norm({"scale": params["q_norm"]}, q, cfg.norm_eps)
        k = rms_norm({"scale": params["k_norm"]}, k, cfg.norm_eps)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)

    new_cache = None
    if layer_cache is not None and T == 1:
        # ---- decode: scatter kv into the cache ring and attend over it ----
        k_cache, v_cache = layer_cache["k"], layer_cache["v"]
        S = k_cache.shape[1]
        idx = (cache_len % S).long()
        bidx = torch.arange(B, device=x.device)
        k_cache[bidx, idx] = k[:, 0]
        v_cache[bidx, idx] = v[:, 0]
        valid = torch.clamp(cache_len + 1, max=S).to(torch.int32)
        out = decode_attention_op(q[:, 0], k_cache, v_cache, valid)
        new_cache = layer_cache
    else:
        # ---- prefill / train: attention over this sequence ----
        out = flash_prefill_op(q, k, v, causal=not cfg.is_encoder,
                               window=window)
        if return_cache:
            new_cache = ({"k": _ring(k, window), "v": _ring(v, window)}
                         if window else {"k": k, "v": v})

    out = out.reshape(B, T, hq * hd)
    return matmul(out, params["wo"]), new_cache


# --------------------------------------------------------------------------- #
# Gated MLP (SwiGLU)
# --------------------------------------------------------------------------- #
def mlp_block(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(matmul(x, params["w_gate"])) * matmul(x, params["w_up"])
    return matmul(h, params["w_down"])


# --------------------------------------------------------------------------- #
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# --------------------------------------------------------------------------- #
def _rglru_coeffs(params: Params, u: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (..., d) conv output.  Returns (log_a, gated input b) in f32."""
    i_gate = torch.sigmoid(matmul(u, params["w_in_gate"]).float())
    r_gate = torch.sigmoid(matmul(u, params["w_rec_gate"]).float())
    log_a = -RGLRU_C * r_gate * F.softplus(params["lambda"].float())
    a2 = torch.exp(2.0 * log_a)
    b = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * i_gate * u.float()
    return log_a, b


def rglru_block(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                        # (B, T, d)
    *,
    layer_cache: Optional[Params],          # {"conv": (B,3,d), "h": (B,d)}
    return_cache: bool,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Prefill (no cache: zero conv history and h, as the engine's prefill
    starts from an empty slot) or decode (T == 1 with a cache).  Decode
    runs the one-step recurrence in plain tensor ops and updates
    ``layer_cache`` IN PLACE (JAX returns a new one).  Casts and rounds
    where ``repro.models.layers.rglru_block`` does: the gate and input
    projections and the conv in the model dtype (the conv summed in f32),
    the gates, ``lambda``'s softplus and the scan in f32, the scan's output
    rounded to the model dtype before the gate product; the cached conv
    history and h are in the model dtype."""
    B, T, d = x.shape
    decoding = layer_cache is not None and T == 1
    if layer_cache is not None and not decoding:
        raise NotImplementedError(
            "rglru_block: a prefill from a carried state is not ported (the "
            "reference prefill reads the carried h but not the carried conv "
            "history)")
    # (tanh: jax's default)
    gate = F.gelu(matmul(x, params["w_gate"]), approximate="tanh")
    xin = matmul(x, params["w_x"])
    conv_w = params["conv_w"].float()

    # temporal conv (width 4, causal) over the history and this input
    if decoding:
        hist = torch.cat([layer_cache["conv"], xin], dim=1)    # (B, 4, d)
        u = (hist.float() * conv_w).sum(1, keepdim=True).to(x.dtype)
    else:
        hist = torch.cat([xin.new_zeros((B, CONV_WIDTH - 1, d)), xin], dim=1)
        u = sum(hist[:, i:i + T].float() * conv_w[i]
                for i in range(CONV_WIDTH)).to(x.dtype)

    log_a, b = _rglru_coeffs(params, u)
    if decoding:
        h = torch.exp(log_a[:, 0]) * layer_cache["h"].float() + b[:, 0]
        y = h[:, None]
        # hist is a new tensor, so its rows 1.. can be copied over the
        # history it was built from
        layer_cache["conv"].copy_(hist[:, 1:])
        layer_cache["h"].copy_(h)
        new_cache = layer_cache
    else:
        y = rglru_scan_op(log_a, b)
        new_cache = ({"conv": hist[:, -(CONV_WIDTH - 1):],
                      "h": y[:, -1].to(x.dtype)} if return_cache else None)
    out = matmul(y.to(x.dtype) * gate, params["w_out"])
    return out, new_cache


# --------------------------------------------------------------------------- #
# RWKV-6 (Finch) time mix with data-dependent decay
# --------------------------------------------------------------------------- #
def rwkv6_block(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                        # (B, T, d)
    *,
    layer_cache: Optional[Params],          # {"shift": (B,d), "state": (B,H,D,D)}
    return_cache: bool,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Prefill (no cache: zero shift and state, as the engine's prefill
    starts from an empty slot) or decode (T == 1 with a cache).  Decode
    runs the one-step recurrence in plain tensor ops and updates
    ``layer_cache`` IN PLACE (JAX returns a new one).  Casts and rounds
    where ``repro.models.layers.rwkv6_block`` does: the token-shift mixes,
    ``g`` and the decay LoRA in the model dtype, r/k/v in f32 after their
    projections, the decay logit and the state in f32."""
    B, T, d = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    decoding = layer_cache is not None and T == 1
    if layer_cache is not None and not decoding:
        raise NotImplementedError(
            "rwkv6_block: a prefill from a carried state is not ported (the "
            "reference prefill does not read the carried state either)")

    if decoding:
        x_prev = layer_cache["shift"][:, None]
    else:
        x_prev = torch.cat([x.new_zeros((B, 1, d)), x[:, :-1]], dim=1)

    mu = params["mu"]

    def mix(i):
        return x * mu[i] + x_prev * (1.0 - mu[i])

    r = matmul(mix(0), params["w_r"]).reshape(B, T, H, D).float()
    k = matmul(mix(1), params["w_k"]).reshape(B, T, H, D).float()
    v = matmul(mix(2), params["w_v"]).reshape(B, T, H, D).float()
    g = F.silu(matmul(mix(3), params["w_g"]))

    dd = matmul(matmul(x, params["decay_lora_a"]), params["decay_lora_b"])
    logit = params["decay_base"].float() + dd.float()
    w = torch.exp(-torch.exp(logit)).reshape(B, T, H, D)     # in (0, 1)
    u = params["bonus_u"].float()

    if decoding:
        S = layer_cache["state"]
        r0, k0, v0 = r[:, 0], k[:, 0], v[:, 0]
        o = (r0 * u * k0).sum(-1, keepdim=True) * v0
        o = (o + torch.einsum("bhd,bhde->bhe", r0, S))[:, None]
        S.mul_(w[:, 0][..., None]).add_(k0[..., None] * v0[..., None, :])
        layer_cache["shift"].copy_(x[:, -1])
        new_cache = layer_cache
    else:
        o, state = rwkv6_scan_op(r, k, v, w, u)
        new_cache = ({"shift": x[:, -1], "state": state} if return_cache
                     else None)

    o = o.reshape(B, T, d).to(x.dtype)
    # the reference's simplification of RWKV's group norm: rms over all d
    o = rms_norm({"scale": params["ln_out_scale"]}, o, cfg.norm_eps)
    return matmul(o * g, params["w_o"]), new_cache


def channel_mix(params: Params, x: torch.Tensor) -> torch.Tensor:
    """RWKV's FFN: squared ReLU."""
    h = torch.square(F.relu(matmul(x, params["w_in"])))
    return matmul(h, params["w_out"])


# --------------------------------------------------------------------------- #
# Mixture of experts, one device (``repro.models.layers`` ``init_moe``,
# ``_moe_local`` and the ``mesh is None`` branch of ``moe_block``)
# --------------------------------------------------------------------------- #
def init_moe(cfg: ModelConfig, generator: torch.Generator, dtype,
             device) -> Params:
    """The leaves and layouts of ``repro.models.layers.init_moe``: router
    (d, E) and w_gate, w_up (E, d, f) at std d^-0.5, w_down (E, f, d) at
    f^-0.5."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return x.mul_(std).to(device)
    std = d ** -0.5
    return {"router": normal((d, e), std),
            "w_gate": normal((e, d, f), std),
            "w_up": normal((e, d, f), std),
            "w_down": normal((e, f, d), f ** -0.5)}


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows of each expert's buffer for a call over ``n_tokens`` tokens:
    the reference's expression, Python float arithmetic then ``int``."""
    return max(1, int(n_tokens * cfg.top_k / cfg.num_experts
                      * cfg.capacity_factor))


def moe_route(params: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Top-k routing of x (T, d) as ``_moe_local`` does it: router logits
    (T, E) in x's dtype then f32; the k largest with the lower expert index
    first on ties (as ``jax.lax.top_k``; a stable descending sort, where
    ``torch.topk`` orders ties as it likes); their softmax in f32; each
    (token, choice)'s position in its expert's queue (an exclusive cumsum
    over the token-major, choice-minor (T*k, E) one-hot) and ``keep =
    pos < cap``.  Fixed shapes and no host sync.  Returns the logits
    (T, E), and weights, experts, pos and keep (T, k)."""
    T = x.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    logits = matmul(x, params["router"]).float()                 # (T, E)
    order = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(order.values[:, :k], dim=-1)
    experts = order.indices[:, :k]                            # (T, k)
    ids = torch.arange(E, device=x.device)
    flat = (experts[..., None] == ids).to(torch.int32).reshape(T * k, E)
    pos = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
    pos = (pos * flat).sum(-1, dtype=torch.int32).reshape(T, k)
    keep = pos < moe_capacity(cfg, T)
    return {"logits": logits, "weights": weights, "experts": experts,
            "pos": pos, "keep": keep}


def _moe_local(params: Params, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    """Capacity-routed MoE over all E experts of x (T, d): the f32 sum of
    each token's kept choices, expert output times routing weight.  Step
    for step ``repro.models.layers._moe_local`` over experts [0, E): per
    expert in index order, its kept tokens are scattered into a (cap + 1,
    d) buffer in x's dtype (row cap takes every dropped token, summed and
    discarded), its SwiGLU runs on the first cap rows, and each token
    gathers its row back (a zero row if dropped).  The expert products
    stay ``torch.matmul``: the reference computes them outside any Pallas
    kernel."""
    T, d = x.shape
    cap = moe_capacity(cfg, T)
    r = moe_route(params, cfg, x)
    experts, pos, keep = r["experts"], r["pos"], r["keep"]
    zero_row = x.new_zeros((1, d), dtype=torch.float32)
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        sel = (experts == e) & keep                           # (T, k)
        slot_t = torch.where(sel, pos, cap).amin(-1).long()   # (T,)
        w_t = torch.where(sel, r["weights"], 0.0).sum(-1)     # (T,)
        buf = x.new_zeros((cap + 1, d)).index_add_(0, slot_t, x)[:cap]
        h = F.silu(matmul(buf, params["w_gate"][e])) * matmul(
            buf, params["w_up"][e])
        eo = matmul(h, params["w_down"][e]).float()              # (cap, d)
        gathered = torch.cat([eo, zero_row])[slot_t]
        out = out + gathered * w_t[:, None]
    return out


def moe_block(params: Params, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    """MoE FFN over x (B, T, d) on one device: the ``mesh is None`` branch
    of ``repro.models.layers.moe_block``.  All B*T tokens of the call are
    routed together, so the capacity, and with it which choices drop,
    depends on the whole batch: a decode step's free slots compete with
    the live ones.  The reference's expert-parallel ``shard_map`` path and
    its weight-tensor-parallel ``_moe_local_wtp`` wait for the port's
    multi-device work."""
    B, T, d = x.shape
    y = _moe_local(params, cfg, x.reshape(B * T, d))
    return y.reshape(B, T, d).to(x.dtype)
