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

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, RGLRU, RWKV6,
                                      ModelConfig)
from repro_torch.kernels.ops import (decode_attention_op, flash_prefill_op,
                                     rglru_scan_op, rwkv6_scan_op)
from repro_torch.models.spmd import (P, is_dtensor, matmul_placements,
                                     partial_on, psum, region, to_placements)

Params = Dict[str, Any]

DECAY_LORA = 64        # rank of the RWKV-6 decay LoRA (layers.py DECAY_LORA)
CONV_WIDTH = 4         # RG-LRU temporal conv (layers.py CONV_WIDTH)
RGLRU_C = 8.0          # RG-LRU decay scale (layers.py RGLRU_C)


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """Axis names of the active mesh (``repro.models.layers.MeshInfo``);
    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` whose
    ``mesh_dim_names`` are the axis names, or None for one device, where
    every path runs as it does without a mesh.

    kv_shard selects the KV-cache layout:
      * "heads":    (B, S, kv->model, hd)  — replicates when kv % model != 0
      * "head_dim": (B, S, kv, hd->model)  — always divides; the attention
        kernels fuse the softmax over whole heads, so each block gathers
        the head dim before its kernel (the reference contracts the shards
        and all-reduces the scores instead)
    fsdp_params additionally shards the weights over the batch axes
    (``repro_torch.models.shardings``); remat_group checkpoints every G
    layers (each layer inside checkpointed too) instead of every layer.
    The reference's unroll_layers has no counterpart: it swaps lax.scan
    over the layers for a Python loop, and the port's forward always
    loops in Python.
    """
    mesh: Optional[Any] = None
    batch_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    kv_shard: str = "heads"
    fsdp_params: bool = False
    remat_group: int = 1

    def axis_size(self, name: str) -> int:
        return self.mesh.shape[self.mesh.mesh_dim_names.index(name)]

    @property
    def model_size(self) -> int:
        if self.mesh is None or self.model_axis is None:
            return 1
        return self.axis_size(self.model_axis)

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        return self.mesh.get_local_rank(name)


def _bspec(mi: MeshInfo):
    """The batch dim's spec entry, as a 1-tuple to splat into a spec."""
    return (mi.batch_axes,) if mi.batch_axes else (None,)


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
    if is_dtensor(w):
        return _matmul_sharded(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _matmul_sharded(x, w):
    """``matmul`` of DTensors as a local product in a region, placed as
    Megatron places it (``spmd.matmul_placements``): each shard multiplies
    its own pieces, so no device computes another's part."""
    xs, ws, outs = matmul_placements(x, w)
    return region(w.device_mesh, matmul, (x, w), (xs, ws), outs)


def soft_cap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


# --------------------------------------------------------------------------- #
# Rotary embeddings (full / half / mrope; pairs-first half-split layout,
# not interleaved)
# --------------------------------------------------------------------------- #
def _rope_freqs(theta: float, n_freq: int, device) -> torch.Tensor:
    """1 / theta^(i / n_freq) in f32, with the reference's bits: the f32
    exponent, ``theta ** exponent`` taken in float64 and rounded to f32
    (the correctly rounded f32 power that XLA's pow gives, where torch's
    f32 pow is an ulp off at some (theta, i)), then the f32 reciprocal.
    At position 524287 that ulp (recurrentgemma-2b's frequency 111) moved
    the rotated output by 2.8e-5."""
    exponent = torch.arange(0, n_freq, dtype=torch.float32,
                            device=device) / n_freq
    power = (theta ** exponent.double()).float()
    return 1.0 / power


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
    mi: MeshInfo = MeshInfo(),
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Prefill (full sequence) or decode (T == 1 with a cache).  Decode
    writes the new k/v into ``layer_cache`` IN PLACE at ring index
    ``cache_len % S`` (JAX returns an updated copy; the port saves the
    cache's memory) and returns the same dict.  With a ``window`` the
    prefill attends over it and returns its k/v ring-ordered in ``window``
    rows, the size of a sliding-window layer's cache (S == window).
    Without a mesh the decode is ``attention_decode_in``, the kernel and
    ``attention_decode_out``.

    On a mesh the projections are DTensor products; rotary, the cache
    write and the kernel run in a local region (``_attend_sharded``) with
    the heads on the model axis and the batch on the batch axes, the
    placements the reference's sharding constraints name."""
    B, T, _ = x.shape
    if mi.mesh is None and layer_cache is not None and T == 1:
        q, valid = attention_decode_in(params, cfg, x, positions,
                                       layer_cache, cache_len)
        out = decode_attention_op(q, layer_cache["k"], layer_cache["v"],
                                  valid)
        return attention_decode_out(params, cfg, out), layer_cache
    q, k, v = _qkv(params, cfg, x, mi)
    if mi.mesh is None:
        out, new_cache = _attend(cfg, q, k, v, positions, window,
                                 layer_cache, cache_len, return_cache)
        out = out.reshape(B, T, cfg.num_heads * cfg.head_dim)
    else:          # (B, T, hq * hd) already
        out, new_cache = _attend_sharded(mi, cfg, q, k, v, positions, window,
                                         layer_cache, cache_len,
                                         return_cache)
    return matmul(out, params["wo"]), new_cache


def _qkv(params: Params, cfg: ModelConfig, x: torch.Tensor, mi: MeshInfo):
    """q (B, T, Hq, D), k and v (B, T, Hkv, D): the projections, the qkv
    bias and the per-head q/k RMSNorm (qwen3-4b), before rotary."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = matmul(x, params["wq"])
    k = matmul(x, params["wk"])
    v = matmul(x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = split_heads(mi, q, hq, hd)
    k = split_heads(mi, k, hkv, hd)
    v = split_heads(mi, v, hkv, hd)
    if cfg.qk_norm:
        # per head, over head_dim
        q = rms_norm({"scale": params["q_norm"]}, q, cfg.norm_eps)
        k = rms_norm({"scale": params["k_norm"]}, k, cfg.norm_eps)
    return q, k, v


def _cache_write(k_cache, v_cache, k, v, cache_len) -> None:
    """A decode step's k/v (B, 1, Hkv, D) into row ``cache_len % S`` of
    each sequence's (B, S, Hkv, D) cache ring, in place."""
    idx = (cache_len % k_cache.shape[1]).long()
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[bidx, idx] = k[:, 0]
    v_cache[bidx, idx] = v[:, 0]


def attention_decode_in(params: Params, cfg: ModelConfig, x: torch.Tensor,
                        positions: torch.Tensor, layer_cache: Params,
                        cache_len: torch.Tensor):
    """A decode step's attention up to its kernel, without a mesh: the
    projections, qkv bias, heads, qk-norm and rotary, the new k/v written
    into the ring at ``cache_len % S``.  Returns the kernel's q (B, Hq, D)
    and its valid rows, ``min(cache_len + 1, S)`` in int32."""
    q, k, v = _qkv(params, cfg, x, MeshInfo())
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    S = layer_cache["k"].shape[1]
    _cache_write(layer_cache["k"], layer_cache["v"], k, v, cache_len)
    return q[:, 0], torch.clamp(cache_len + 1, max=S).to(torch.int32)


def attention_decode_out(params: Params, cfg: ModelConfig,
                         out: torch.Tensor) -> torch.Tensor:
    """The rest of a decode step's attention from the kernel's output
    (B, Hq, D): the output projection, (B, 1, d)."""
    B = out.shape[0]
    return matmul(out.reshape(B, 1, cfg.num_heads * cfg.head_dim),
                  params["wo"])


def _attend(cfg: ModelConfig, q, k, v, positions, window, layer_cache,
            cache_len, return_cache, kv_heads=None, write=True):
    """Rotary, the decode's cache write and the attention kernel on local
    tensors: (out (B,T,Hq,D), the prefill's k/v cache or the decode's
    ``layer_cache``, or None).  ``kv_heads`` = (lo, hi) attends over those
    k/v heads only (a model shard's q heads over a replicated cache);
    ``write=False`` skips the cache write (done already)."""
    T = q.shape[1]
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)

    def heads(t):
        return t if kv_heads is None else \
            t[:, :, kv_heads[0]:kv_heads[1]].contiguous()

    new_cache = None
    if layer_cache is not None and T == 1:
        # ---- decode: scatter kv into the cache ring and attend over it ----
        k_cache, v_cache = layer_cache["k"], layer_cache["v"]
        S = k_cache.shape[1]
        if write:
            _cache_write(k_cache, v_cache, k, v, cache_len)
        valid = torch.clamp(cache_len + 1, max=S).to(torch.int32)
        out = decode_attention_op(q[:, 0], heads(k_cache), heads(v_cache),
                                  valid)[:, None]
        new_cache = layer_cache
    else:
        # ---- prefill / train: attention over this sequence ----
        out = flash_prefill_op(q, heads(k), heads(v),
                               causal=not cfg.is_encoder, window=window)
        if return_cache:
            new_cache = ({"k": _ring(k, window), "v": _ring(v, window)}
                         if window else {"k": k, "v": v})
    return out, new_cache


def split_heads(mi: MeshInfo, t: torch.Tensor, heads: int,
                hd: int) -> torch.Tensor:
    """(B, T, heads * hd) -> (B, T, heads, hd).  On a mesh the flat
    projection is first placed so that the reshape keeps whole heads on
    each model shard: sharded over the model axis where the heads divide
    it, replicated where they do not (as ``fit_spec`` replicates them)."""
    B, T = t.shape[0], t.shape[1]
    if mi.mesh is not None:
        m = head_axis(mi, heads)
        t = t.redistribute(mi.mesh, to_placements(
            P(*_bspec(mi), None, m), mi.mesh))
    return t.reshape(B, T, heads, hd)


def head_axis(mi: MeshInfo, n: int) -> Optional[str]:
    """The model axis where ``n`` heads (or channels) divide it, else
    None (replicated)."""
    if mi.mesh is None or mi.model_axis is None or n % mi.model_size:
        return None
    return mi.model_axis


def _attend_sharded(mi: MeshInfo, cfg: ModelConfig, q, k, v, positions,
                    window, layer_cache, cache_len, return_cache):
    """``_attend`` in local regions, its output flattened to (B, T,
    Hq * D) inside them (a DTensor reshape that splits a sharded dim into
    heads it does not divide cannot run, and autograd would ask for one
    in the backward).  q's heads shard over the model axis
    where they divide it, k/v's where theirs do (the cache's layout,
    ``cache_pspecs``); where only q's do, each model shard attends its q
    heads over the k/v heads they read (kv_heads), which needs whole GQA
    groups or whole kv heads per shard, else q replicates too.  With
    ``kv_shard="head_dim"`` the cache shards D: the decode writes its
    shard of the new row in place, then the cache is all-gathered over D
    for the kernel, which softmaxes whole heads."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b = _bspec(mi)[0]
    m = mi.model_size
    qa, kva = head_axis(mi, hq), head_axis(mi, hkv)
    G = hq // hkv
    if qa and not kva:
        hq_l = hq // m
        if hq_l % G and G % hq_l:
            qa = None
    q_spec = P(b, None, qa, None)
    flat_spec = P(b, None, qa)           # (B, T, Hq * D): whole heads
    kv_spec = P(b, None, kva, None)
    pos_spec = P(b, *([None] * (positions.ndim - 1)))
    lens_spec = P(b)

    def kv_range():
        if not qa or kva:
            return None
        hq_l = hq // m
        r = mi.axis_index(mi.model_axis)
        return (r * hq_l // G, ((r + 1) * hq_l - 1) // G + 1)

    decoding = layer_cache is not None and q.shape[1] == 1
    if decoding:
        write = True
        if mi.kv_shard == "head_dim":
            d_spec = P(b, None, None, head_axis(mi, hd))

            def write_fn(k, v, kc, vc, lens, pos):
                _cache_write(kc, vc, apply_rope(cfg, k, pos), v, lens)
                return kc
            region(mi, write_fn, (k, v, layer_cache["k"], layer_cache["v"],
                                  cache_len, positions),
                   (d_spec, d_spec, d_spec, d_spec, lens_spec, pos_spec),
                   None)
            write = False

        def dec_fn(q, k, v, kc, vc, lens, pos):
            out, _ = _attend(cfg, q, k, v, pos, window, {"k": kc, "v": vc},
                             lens, False, kv_range(), write)
            return out.flatten(2)
        out = region(mi, dec_fn, (q, k, v, layer_cache["k"],
                                  layer_cache["v"], cache_len, positions),
                     (q_spec, kv_spec, kv_spec, kv_spec, kv_spec, lens_spec,
                      pos_spec), flat_spec)
        return out, layer_cache

    def pre_fn(q, k, v, pos):
        out, nc = _attend(cfg, q, k, v, pos, window, None, None,
                          return_cache, kv_range())
        out = out.flatten(2)
        return (out, nc["k"], nc["v"]) if return_cache else (out, None, None)
    out, kc, vc = region(mi, pre_fn, (q, k, v, positions),
                         (q_spec, kv_spec, kv_spec, pos_spec),
                         [flat_spec, kv_spec if return_cache else None,
                          kv_spec if return_cache else None])
    new_cache = None
    if return_cache:
        if mi.kv_shard == "head_dim":
            pl = to_placements(P(b, None, None, head_axis(mi, hd)), mi.mesh)
            kc, vc = kc.redistribute(mi.mesh, pl), vc.redistribute(mi.mesh,
                                                                   pl)
        new_cache = {"k": kc, "v": vc}
    return out, new_cache


def batch_placed(mi: MeshInfo, t: torch.Tensor) -> torch.Tensor:
    """On a mesh, the activation ``t`` (B, ...) placed as the residual
    stream is: batch over the batch axes, replicated over the model axis
    (a block's Partial output all-reduced, Megatron's pattern); ``t``
    itself without a mesh."""
    if mi.mesh is None:
        return t
    pl = to_placements(P(*_bspec(mi), *([None] * (t.ndim - 1))), mi.mesh)
    return t if tuple(t.placements) == pl else t.redistribute(mi.mesh, pl)


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; for DTensors, src placed as dst first, so the
    copy is local."""
    if is_dtensor(dst):
        src = src.redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


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
    del r_gate      # (each f32 (T, d) goes when spent: 5.4 GB at T 524288)
    a2 = torch.exp(2.0 * log_a)
    scale = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12))
    del a2
    return log_a, scale * i_gate * u.float()


def rglru_block(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                        # (B, T, d)
    *,
    layer_cache: Optional[Params],          # {"conv": (B,3,d), "h": (B,d)}
    return_cache: bool,
    mi: MeshInfo = MeshInfo(),
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Prefill (no cache: zero conv history and h, as the engine's prefill
    starts from an empty slot) or decode (T == 1 with a cache).  Decode
    runs the one-step recurrence in plain tensor ops and updates
    ``layer_cache`` IN PLACE (JAX returns a new one).  Casts and rounds
    where ``repro.models.layers.rglru_block`` does: the gate and input
    projections and the conv in the model dtype (the conv summed in f32),
    the gates, ``lambda``'s softplus and the scan in f32, the scan's output
    rounded to the model dtype before the gate product; the cached conv
    history and h are in the model dtype.  On a mesh the conv and the scan
    are channel-wise local regions (channels on the model axis where they
    divide it); the gates are DTensor products."""
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

    def conv(xin, conv_w, hist_cache):
        """The temporal conv (width 4, causal) over the history and this
        input: (u, the new history (B, 3, d)); a decode writes the history
        into ``hist_cache`` in place."""
        conv_w = conv_w.float()
        if hist_cache is not None:
            hist = torch.cat([hist_cache, xin], dim=1)        # (B, 4, d)
            u = (hist.float() * conv_w).sum(1, keepdim=True).to(xin.dtype)
            # hist is a new tensor, so its rows 1.. can be copied over the
            # history it was built from
            hist_cache.copy_(hist[:, 1:])
            return u, hist_cache
        Bl = xin.shape[0]
        hist = torch.cat([xin.new_zeros((Bl, CONV_WIDTH - 1, xin.shape[2])),
                          xin], dim=1)
        u = sum(hist[:, i:i + T].float() * conv_w[i]
                for i in range(CONV_WIDTH)).to(xin.dtype)
        # (copies: a view would keep the whole (B, T + 3, d) history alive
        # in the prefill's cache, 2.7 GB a layer at 524288 positions)
        return u, hist[:, -(CONV_WIDTH - 1):].clone()

    hc = layer_cache["conv"] if decoding else None
    if mi.mesh is None:
        u, hist = conv(xin, params["conv_w"], hc)
        scan = rglru_scan_op
    else:
        bb, c = _bspec(mi)[0], head_axis(mi, d)
        ch = P(bb, None, c)
        u, hist = region(mi, conv, (xin, params["conv_w"], hc),
                         (ch, P(None, c), ch if decoding else None),
                         [ch, ch])

        def scan(log_a, b):
            return region(mi, rglru_scan_op, (log_a, b), (ch, ch), ch)

    del xin
    log_a, b = _rglru_coeffs(params, u)
    del u           # (a long prefill's intermediates go as they finish)
    if decoding:
        h = torch.exp(log_a[:, 0]) * layer_cache["h"].float() + b[:, 0]
        y = h[:, None]
        assign(layer_cache["h"], h)
        new_cache = layer_cache
    else:
        y = scan(log_a, b)
        del log_a, b
        new_cache = ({"conv": hist, "h": y[:, -1].to(x.dtype, copy=True)}
                     if return_cache else None)
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
    mi: MeshInfo = MeshInfo(),
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Prefill (no cache: zero shift and state, as the engine's prefill
    starts from an empty slot) or decode (T == 1 with a cache).  Decode
    runs the one-step recurrence in plain tensor ops and updates
    ``layer_cache`` IN PLACE (JAX returns a new one).  Casts and rounds
    where ``repro.models.layers.rwkv6_block`` does: the token-shift mixes,
    ``g`` and the decay LoRA in the model dtype, r/k/v in f32 after their
    projections, the decay logit and the state in f32.  On a mesh the
    token shift and the WKV recurrence (scan or decode step) are local
    regions, per head (heads on the model axis where they divide it)."""
    B, T, d = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    decoding = layer_cache is not None and T == 1
    if layer_cache is not None and not decoding:
        raise NotImplementedError(
            "rwkv6_block: a prefill from a carried state is not ported (the "
            "reference prefill does not read the carried state either)")

    def shifted(x):
        return torch.cat([x.new_zeros((x.shape[0], 1, d)), x[:, :-1]], dim=1)

    if mi.mesh is not None:
        bb, h_ax = _bspec(mi)[0], head_axis(mi, H)
    if decoding:
        x_prev = layer_cache["shift"][:, None]
    elif mi.mesh is None:
        x_prev = shifted(x)
    else:
        x_prev = region(mi, shifted, (x,), (P(bb, None, None),),
                        P(bb, None, None))

    mu = params["mu"]

    def mix(i):
        return x * mu[i] + x_prev * (1.0 - mu[i])

    r = split_heads(mi, matmul(mix(0), params["w_r"]), H, D).float()
    k = split_heads(mi, matmul(mix(1), params["w_k"]), H, D).float()
    v = split_heads(mi, matmul(mix(2), params["w_v"]), H, D).float()
    g = F.silu(matmul(mix(3), params["w_g"]))
    del x_prev          # (a long prefill's intermediates go as they finish)

    dd = matmul(matmul(x, params["decay_lora_a"]), params["decay_lora_b"])
    logit = params["decay_base"].float() + dd.float()
    del dd
    w = split_heads(mi, torch.exp(-torch.exp(logit)), H, D)  # in (0, 1)
    del logit
    u = params["bonus_u"].float()

    def step(r, k, v, w, u, S):
        """One decode step of the recurrence, o flattened to (B, 1, H*D);
        S (B,H,D,D) in place."""
        r0, k0, v0 = r[:, 0], k[:, 0], v[:, 0]
        o = (r0 * u * k0).sum(-1, keepdim=True) * v0
        o = (o + torch.einsum("bhd,bhde->bhe", r0, S))[:, None]
        S.mul_(w[:, 0][..., None]).add_(k0[..., None] * v0[..., None, :])
        return o.flatten(2)

    def scan(r, k, v, w, u):
        """The scan, o flattened to (B, T, H*D) (on a mesh inside the
        region, as ``_attend_sharded`` flattens)."""
        o, state = rwkv6_scan_op(r, k, v, w, u)
        return o.flatten(2), state

    if mi.mesh is not None:
        hs, flat = P(bb, None, h_ax, None), P(bb, None, h_ax)
    if decoding:
        if mi.mesh is None:
            o = step(r, k, v, w, u, layer_cache["state"])
        else:
            o = region(mi, step, (r, k, v, w, u, layer_cache["state"]),
                       (hs, hs, hs, hs, P(h_ax, None),
                        P(bb, h_ax, None, None)), flat)
        assign(layer_cache["shift"], x[:, -1])
        new_cache = layer_cache
    else:
        if mi.mesh is None:
            o, state = scan(r, k, v, w, u)
        else:
            o, state = region(mi, scan, (r, k, v, w, u),
                              (hs, hs, hs, hs, P(h_ax, None)),
                              [flat, P(bb, h_ax, None, None)])
        del r, k, v, w
        new_cache = ({"shift": x[:, -1].clone(), "state": state}
                     if return_cache else None)

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
        if torch.device(device).type == "meta":
            return torch.empty(shape, dtype=dtype, device="meta")
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
    (T, E) in f32 from x and the router as they are (XLA folds the
    reference's ``(x @ router).astype(float32)`` into one f32 product of
    the upcast operands, so bf16 logits are not rounded to bf16 first: a
    rounding that ties or swaps near-equal experts); the k largest with the lower expert index
    first on ties (as ``jax.lax.top_k``; a stable descending sort, where
    ``torch.topk`` orders ties as it likes); their softmax in f32; each
    (token, choice)'s position in its expert's queue (an exclusive cumsum
    over the token-major, choice-minor (T*k, E) one-hot) and ``keep =
    pos < cap``.  Fixed shapes and no host sync.  Returns the logits
    (T, E), and weights, experts, pos and keep (T, k)."""
    T = x.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    logits = matmul(x.float(), params["router"].float())         # (T, E)
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


def _moe_local(params: Params, cfg: ModelConfig, x: torch.Tensor,
               expert_lo: int = 0, n_local: Optional[int] = None
               ) -> torch.Tensor:
    """Capacity-routed MoE of x (T, d) over experts [expert_lo, expert_lo
    + n_local) (all E by default), whose weights are ``params``' rows 0 ..
    n_local - 1: the f32 sum of each token's kept choices of those experts,
    expert output times routing weight (the caller sums the expert shards'
    parts).  Step for step ``repro.models.layers._moe_local``: per expert
    in index order, its kept tokens are scattered into a (cap + 1, d)
    buffer in x's dtype (row cap takes every dropped token, summed and
    discarded), its SwiGLU runs on the first cap rows, and each token
    gathers its row back (a zero row if dropped).  The expert products
    stay ``torch.matmul``: the reference computes them outside any Pallas
    kernel."""
    T, d = x.shape
    n_local = cfg.num_experts if n_local is None else n_local
    cap = moe_capacity(cfg, T)
    r = moe_route(params, cfg, x)
    experts, pos, keep = r["experts"], r["pos"], r["keep"]
    zero_row = x.new_zeros((1, d), dtype=torch.float32)
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(n_local):
        sel = (experts == expert_lo + j) & keep               # (T, k)
        slot_t = torch.where(sel, pos, cap).amin(-1).long()   # (T,)
        w_t = torch.where(sel, r["weights"], 0.0).sum(-1)     # (T,)
        buf = x.new_zeros((cap + 1, d)).index_add_(0, slot_t, x)[:cap]
        h = F.silu(matmul(buf, params["w_gate"][j])) * matmul(
            buf, params["w_up"][j])
        eo = matmul(h, params["w_down"][j]).float()              # (cap, d)
        gathered = torch.cat([eo, zero_row])[slot_t]
        out += gathered * w_t[:, None]    # (in place: (T, d) f32 is 10.7 GB
    return out                            # at llama4-scout's 524288 tokens)


def _moe_local_wtp(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   expert_lo: int, n_local: int, d_idx: int, n_d: int,
                   mi: MeshInfo, data_axes: Tuple[str, ...]) -> torch.Tensor:
    """Weight-tensor-parallel MoE for the batch-replicated case (batch 1
    decode; ``repro.models.layers._moe_local_wtp``): each expert's d_model
    contraction is split over the otherwise idle data axes (shard
    ``d_idx`` of ``n_d``), the partial products summed over them, then
    each shard's slice of the d_ff contraction; returns the FULL output,
    summed over the model and data axes."""
    T, d = x.shape
    d_loc, f_loc = d // n_d, cfg.d_ff // n_d
    cap = moe_capacity(cfg, T)
    r = moe_route(params, cfg, x)                     # router replicated
    experts, pos, keep = r["experts"], r["pos"], r["keep"]
    x_slice = x[:, d_idx * d_loc:(d_idx + 1) * d_loc]
    zero_row = x.new_zeros((1, d), dtype=torch.float32)
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(n_local):
        sel = (experts == expert_lo + j) & keep
        slot_t = torch.where(sel, pos, cap).amin(-1).long()
        w_t = torch.where(sel, r["weights"], 0.0).sum(-1)
        buf = x_slice.new_zeros((cap + 1, d_loc)).index_add_(
            0, slot_t, x_slice)[:cap]
        # partial over the d_in contraction -> summed over the data axes
        a = psum(matmul(buf, params["w_gate"][j]), mi, data_axes)
        b = psum(matmul(buf, params["w_up"][j]), mi, data_axes)
        h = F.silu(a) * b                                    # (cap, f) full
        h_slice = h[:, d_idx * f_loc:(d_idx + 1) * f_loc]
        eo = matmul(h_slice, params["w_down"][j]).float()    # partial
        gathered = torch.cat([eo, zero_row])[slot_t]
        out = out + gathered * w_t[:, None]
    # partial over (f contraction x expert shards)
    return psum(out, mi, (mi.model_axis,) + tuple(data_axes))


def moe_block(params: Params, cfg: ModelConfig, x: torch.Tensor,
              mi: MeshInfo = MeshInfo()) -> torch.Tensor:
    """MoE FFN over x (B, T, d), ``repro.models.layers.moe_block``'s three
    branches.  On one device (``mi.mesh`` None) all B*T tokens of the call
    are routed together, so the capacity, and with it which choices drop,
    depends on the whole batch: a decode step's free slots compete with
    the live ones.

    On a mesh the experts shard over the model axis (expert parallelism,
    the reference's ``shard_map``): activations are replicated across the
    model axis, so in a local region each model shard routes all the
    tokens of its batch shard to its own E / model experts through
    ``_moe_local`` and the shards' partial outputs are summed, one
    all-reduce a layer (the region's output is Partial over the model
    axis, made Replicate).  Where E does not divide the model axis the
    experts are replicated and every shard computes the whole MoE over
    the whole batch, as the reference's GSPMD program does.  When the
    batch cannot use the batch axes (batch 1 decode) and
    ``mi.fsdp_params`` is set, the expert weights also split their
    contraction dims over the data axes (``_moe_local_wtp``)."""
    B, T, d = x.shape
    E = cfg.num_experts

    if mi.mesh is None or mi.model_axis is None:
        y = _moe_local(params, cfg, x.reshape(B * T, d))
        return y.reshape(B, T, d).to(x.dtype)

    n_model = mi.model_size
    M = mi.model_axis
    if E % n_model != 0:
        # experts don't divide the model axis: replicated, and the whole
        # MoE over the whole batch on every shard
        names = sorted(params)

        def whole(xl, *ws):
            y = _moe_local(dict(zip(names, ws)), cfg, xl.reshape(B * T, d))
            return y.reshape(B, T, d).to(xl.dtype)
        return region(mi, whole, (x, *[params[k] for k in names]),
                      (P(),) * (1 + len(names)), P())
    n_local = E // n_model
    n_b = 1
    for a in mi.batch_axes:
        n_b *= mi.axis_size(a)
    batch_ok = bool(mi.batch_axes) and B % n_b == 0
    bspec = mi.batch_axes if batch_ok else None
    data_axes = tuple(a for a in mi.mesh.mesh_dim_names if a != M)
    n_d = 1
    for a in data_axes:
        n_d *= mi.axis_size(a)
    use_wtp = (mi.fsdp_params and not batch_ok and n_d > 1
               and d % n_d == 0 and cfg.d_ff % n_d == 0)
    wspec = P(M, data_axes if use_wtp else None, None)
    names = sorted(params)

    def local_fn(xl, *ws):
        p_loc = dict(zip(names, ws))
        lo = mi.axis_index(M) * n_local
        Bl, Tl, _ = xl.shape
        if use_wtp:
            d_idx, mult = 0, 1
            for a in reversed(data_axes):
                d_idx += mi.axis_index(a) * mult
                mult *= mi.axis_size(a)
            y = _moe_local_wtp(p_loc, cfg, xl.reshape(Bl * Tl, d), lo,
                               n_local, d_idx, n_d, mi, data_axes)
        else:
            y = _moe_local(p_loc, cfg, xl.reshape(Bl * Tl, d), lo, n_local)
        return y.reshape(Bl, Tl, d).to(xl.dtype)

    xs = P(bspec, None, None)
    specs = [P() if k == "router" else wspec for k in names]
    out_pl = to_placements(xs, mi.mesh)
    if not use_wtp:      # the expert shards' parts: summed over the model
        out_pl = partial_on(out_pl, mi.mesh, M)
    y = region(mi, local_fn, (x, *[params[k] for k in names]),
               (xs, *specs), out_pl)
    if not use_wtp:
        y = y.redistribute(mi.mesh, to_placements(xs, mi.mesh))
    return y
