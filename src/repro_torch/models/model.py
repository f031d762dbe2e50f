"""The port's decoders: init / forward / cache, in PyTorch.

Counterpart of ``repro.models.model``: dense GQA decoders (ATTN or
LOCAL_ATTN blocks; a vision model's patch embeddings through its
``frontend`` projection before the tokens), the bidirectional audio
encoder (hubert-xlarge: frames through ``frontend``, no tokens), their MoE
variants (the SwiGLU replaced by ``moe_block``), Griffin (RGLRU and
LOCAL_ATTN blocks) and RWKV-6 (RWKV6 blocks).  The JAX package stacks
layers per pattern position and scans over them; here
``params["layers"]`` is a plain list in layer order (``params_from_jax``
maps one onto the other; layer ``i`` has kind
``cfg.block_pattern[i % len(cfg.block_pattern)]``) and the forward loops
over it.  With grad enabled and no cache, each block runs under
``torch.utils.checkpoint`` (the reference checkpoints each cycle of
blocks): its activations are recomputed in the backward, so a training
step holds one block's internals at a time.  ``make_loss_fn`` is the
training loss.

The cache holds one preallocated tensor per key, stacking the layers of
the kind that uses the key (``CACHE_KEYS``):

* ATTN:  ``"k"``, ``"v"``: (L_attn, B, S, Hkv, D) in the model dtype;
* LOCAL_ATTN: ``"local_k"``, ``"local_v"``: (L_local, B, W, Hkv, D) in the
  model dtype, W the sliding window whatever S is, ring-ordered (position
  p at row p % W);
* RGLRU: ``"conv"``: (L_rglru, B, 3, d) and ``"h"``: (L_rglru, B, d), both
  in the model dtype;
* RWKV6: ``"shift"``: (L_rwkv, B, d) in the model dtype, ``"state"``:
  (L_rwkv, B, H, D, D) in f32.

Layer ``i``'s cache is the view ``cache[key][j]``, ``j`` its index among
the layers of its kind, and decode writes into it in place.  A new block
kind adds its own keys; the keys of the others stay as they are.

Forward modes:
  * prefill: full sequence, ``return_cache=True`` returns this sequence's
             cache in the same layout (global k/v with T rows, local k/v
             ring-ordered in W rows);
  * decode:  T == 1 step against ``cache`` / ``cache_len``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, RGLRU, RWKV6,
                                      ModelConfig)
from repro_torch.models import layers as L
from repro_torch.models.layers import MeshInfo
from repro_torch.models.spmd import (P, partial_on, place, region,
                                     to_placements)

Params = Dict[str, Any]

# block kind -> {key of the block's layer cache: key of the model's cache}
CACHE_KEYS = {ATTN: {"k": "k", "v": "v"},
              LOCAL_ATTN: {"k": "local_k", "v": "local_v"},
              RGLRU: {"conv": "conv", "h": "h"},
              RWKV6: {"shift": "shift", "state": "state"}}
SEQ_KEYS = ("k", "v")        # keys whose prefill fills only rows [:T]


def layer_kinds(cfg: ModelConfig) -> List[str]:
    plen = len(cfg.block_pattern)
    return [cfg.block_pattern[i % plen] for i in range(cfg.num_layers)]


def _cache_index(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(kind, index among the layers of that kind) of every layer."""
    seen: Dict[str, int] = {}
    out = []
    for kind in layer_kinds(cfg):
        out.append((kind, seen.get(kind, 0)))
        seen[kind] = seen.get(kind, 0) + 1
    return out


# --------------------------------------------------------------------------- #
# Init (same distributions as repro.models.model.init_params)
# --------------------------------------------------------------------------- #
def _normal(generator: torch.Generator, shape, std: float, dtype,
            device) -> torch.Tensor:
    if torch.device(device).type == "meta":     # shapes only, no draw
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device)
    return x.mul_(std).to(device)


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def _uniform(generator: torch.Generator, shape, dtype,
             device) -> torch.Tensor:
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=generator.device).to(device)


def _init_attention(cfg: ModelConfig, generator, dtype, device) -> Params:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    std = d ** -0.5
    core = {
        "wq": _normal(generator, (d, hq * hd), std, dtype, device),
        "wk": _normal(generator, (d, hkv * hd), std, dtype, device),
        "wv": _normal(generator, (d, hkv * hd), std, dtype, device),
        "wo": _normal(generator, (hq * hd, d), std, dtype, device),
    }
    if cfg.qkv_bias:
        core["bq"] = _zeros((hq * hd,), dtype, device)
        core["bk"] = _zeros((hkv * hd,), dtype, device)
        core["bv"] = _zeros((hkv * hd,), dtype, device)
    if cfg.qk_norm:
        core["q_norm"] = _zeros((hd,), dtype, device)
        core["k_norm"] = _zeros((hd,), dtype, device)
    return core


def _init_rwkv6(cfg: ModelConfig, generator, dtype, device) -> Params:
    """The distributions of ``repro.models.layers.init_rwkv6``."""
    d, hd, r = cfg.d_model, cfg.head_dim, L.DECAY_LORA
    std = d ** -0.5
    core = {name: _normal(generator, (d, d), std, dtype, device)
            for name in ("w_r", "w_k", "w_v", "w_g", "w_o")}
    core["mu"] = _uniform(generator, (4, d), dtype, device)   # r,k,v,g
    core["decay_base"] = torch.full((d,), -6.0, dtype=dtype, device=device)
    core["decay_lora_a"] = _normal(generator, (d, r), std, dtype, device)
    core["decay_lora_b"] = _normal(generator, (r, d), r ** -0.5, dtype,
                                   device)
    core["bonus_u"] = _normal(generator, (cfg.num_heads, hd), 0.1, dtype,
                              device)
    core["ln_out_scale"] = _zeros((d,), dtype, device)
    return core


def _init_rglru(cfg: ModelConfig, generator, dtype, device) -> Params:
    """The distributions of ``repro.models.layers.init_rglru``."""
    d = cfg.d_model
    std = d ** -0.5
    core = {name: _normal(generator, (d, d), std, dtype, device)
            for name in ("w_x", "w_gate", "w_out")}
    core["conv_w"] = _normal(generator, (L.CONV_WIDTH, d), 0.1, dtype,
                             device)
    for name in ("w_in_gate", "w_rec_gate"):
        core[name] = _normal(generator, (d, d), std, dtype, device)
    core["lambda"] = torch.full((d,), 1.0, dtype=dtype, device=device)
    return core


def _init_block(cfg: ModelConfig, kind: str, generator, dtype,
                device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if kind == RWKV6:
        core = _init_rwkv6(cfg, generator, dtype, device)
        ffn = {"w_in": _normal(generator, (d, f), d ** -0.5, dtype, device),
               "w_out": _normal(generator, (f, d), f ** -0.5, dtype, device)}
    else:
        core = (_init_rglru if kind == RGLRU else _init_attention)(
            cfg, generator, dtype, device)
        std = d ** -0.5
        ffn = L.init_moe(cfg, generator, dtype, device) if cfg.is_moe else {
            "w_gate": _normal(generator, (d, f), std, dtype, device),
            "w_up": _normal(generator, (d, f), std, dtype, device),
            "w_down": _normal(generator, (f, d), f ** -0.5, dtype, device),
        }
    return {"norm1": {"scale": _zeros((d,), dtype, device)}, "core": core,
            "norm2": {"scale": _zeros((d,), dtype, device)}, "ffn": ffn}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cuda") -> Params:
    """Random weights drawn on ``generator``'s device, placed on
    ``device``.  The draws differ from ``jax.random``'s; a test that needs
    both packages on one set of weights uses ``params_from_jax``.  On
    ``device="meta"`` the leaves are shapes only (``generator`` may be
    None): ``repro_torch.launch.steps.abstract_params``."""
    L.check_supported(cfg)
    params: Params = {
        "embed": _normal(generator, (cfg.vocab_size, cfg.d_model), 0.02,
                         dtype, device),
        "final_norm": {"scale": _zeros((cfg.d_model,), dtype, device)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(generator, (cfg.d_model, cfg.vocab_size),
                                    0.02, dtype, device)
    if cfg.frontend_dim:
        params["frontend"] = _normal(generator, (cfg.frontend_dim,
                                                 cfg.d_model), 0.02, dtype,
                                     device)
    params["layers"] = [_init_block(cfg, kind, generator, dtype, device)
                        for kind in layer_kinds(cfg)]
    return params


# --------------------------------------------------------------------------- #
# Cache
# --------------------------------------------------------------------------- #
def _block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """(shape, dtype) of one layer's cache per block cache key, as
    ``repro.models.model._block_cache``."""
    d, H, D = cfg.d_model, cfg.num_heads, cfg.head_dim
    if kind in (ATTN, LOCAL_ATTN):
        rows = cfg.sliding_window if kind == LOCAL_ATTN else max_len
        shape = (batch, rows, cfg.num_kv_heads, D)
        return {"k": (shape, dtype), "v": (shape, dtype)}
    if kind == RGLRU:
        return {"conv": ((batch, L.CONV_WIDTH - 1, d), dtype),
                "h": ((batch, d), dtype)}
    return {"shift": ((batch, d), dtype),
            "state": ((batch, H, D, D), torch.float32)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device="cuda") -> Params:
    L.check_supported(cfg)
    kinds = layer_kinds(cfg)
    cache: Params = {}
    for kind in CACHE_KEYS:
        n = kinds.count(kind)
        if not n:
            continue
        for key, (shape, dt) in _block_cache(cfg, kind, batch, max_len,
                                             dtype).items():
            cache[CACHE_KEYS[kind][key]] = _zeros((n,) + shape, dt, device)
    return cache


def write_slot(cache: Params, pcache: Params, slot: int, T: int) -> None:
    """Write a one-sequence prefill cache (``forward(..., return_cache=
    True)`` on a batch of 1) into batch row ``slot`` of ``cache`` in place:
    rows ``[:T]`` of the global k/v (rows past T may hold a previous
    request's k/v, which decode masks out), and the whole slot row of the
    others: the local k/v's W ring-ordered rows (zeros past T when T < W,
    as the reference's), and the conv history, h, shift and state (a
    previous request's are overwritten).  The in-place counterpart of the
    JAX engine's ``_merge_slot``."""
    for key, val in pcache.items():
        if key in SEQ_KEYS:
            cache[key][:, slot, :T] = val[:, 0]
        else:
            cache[key][:, slot] = val[:, 0]


# --------------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------------- #
# positions of a prefill's norm, dense FFN and residual at a time where no
# gradient is taken (each row's result is the same: all three are
# row-wise).  At 524288 positions llama3-8b-sw's SwiGLU would hold three
# (T, 14336) bf16 tensors at once, 45 GB, and rwkv6-3b's channel mix three
# (T, 8960), 28 GB.  The MoE block is not chunked: its capacity is over all
# tokens of the call, so chunks would keep other tokens.
FFN_ROWS = 65536


def _apply_block(cfg: ModelConfig, kind: str, bp: Params, x: torch.Tensor,
                 positions: torch.Tensor, layer_cache: Optional[Params],
                 cache_len: Optional[torch.Tensor], return_cache: bool,
                 mi: MeshInfo = MeshInfo()
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    h = L.rms_norm(bp["norm1"], x, cfg.norm_eps)
    if kind == RWKV6:
        core, new_cache = L.rwkv6_block(
            bp["core"], cfg, h, layer_cache=layer_cache,
            return_cache=return_cache, mi=mi)
    elif kind == RGLRU:
        core, new_cache = L.rglru_block(
            bp["core"], cfg, h, layer_cache=layer_cache,
            return_cache=return_cache, mi=mi)
    else:
        window = cfg.sliding_window if kind == LOCAL_ATTN else 0
        core, new_cache = L.attention_block(
            bp["core"], cfg, h, positions, window=window,
            layer_cache=layer_cache, cache_len=cache_len,
            return_cache=return_cache, mi=mi)
    x = x + L.batch_placed(mi, core)
    del core, h
    if (torch.is_grad_enabled() or cfg.is_moe or mi.mesh is not None
            or x.shape[1] <= FFN_ROWS):
        return _ffn_residual(cfg, kind, bp, x, mi), new_cache
    out = None
    for r0 in range(0, x.shape[1], FFN_ROWS):
        y = _ffn_residual(cfg, kind, bp, x[:, r0:r0 + FFN_ROWS], mi)
        if out is None:
            out = y.new_empty(x.shape)
        out[:, r0:r0 + FFN_ROWS] = y
    return out, new_cache


def _ffn_residual(cfg: ModelConfig, kind: str, bp: Params, x: torch.Tensor,
                  mi: MeshInfo) -> torch.Tensor:
    """x plus the block's FFN (channel mix, MoE or SwiGLU) of its norm."""
    h = L.rms_norm(bp["norm2"], x, cfg.norm_eps)
    if kind == RWKV6:
        ffn = L.channel_mix(bp["ffn"], h)
    elif cfg.is_moe:
        ffn = L.moe_block(bp["ffn"], cfg, h, mi)
    else:
        ffn = L.mlp_block(bp["ffn"], h)
    return x + L.batch_placed(mi, ffn)


# An attention layer's decode step without a mesh, in two halves around
# its kernel, so that ``serving.decode_graph`` can replay each gap between
# two kernels as one CUDA graph while the kernel runs eagerly.
def block_decode_in(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                    positions: torch.Tensor, layer_cache: Params,
                    cache_len: torch.Tensor):
    """The layer's norm and its attention up to the kernel (the new k/v
    written into ``layer_cache``): the kernel's q (B, Hq, D) and valid
    rows (B,)."""
    h = L.rms_norm(bp["norm1"], x, cfg.norm_eps)
    return L.attention_decode_in(bp["core"], cfg, h, positions, layer_cache,
                                 cache_len)


def block_decode_out(cfg: ModelConfig, kind: str, bp: Params,
                     x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The rest of the layer from the kernel's output ``attn`` (B, Hq, D):
    the output projection, the residual and the FFN."""
    x = x + L.attention_decode_out(bp["core"], cfg, attn)
    return _ffn_residual(cfg, kind, bp, x, MeshInfo())


def _default_positions(cfg: ModelConfig, batch: int, seqlen: int,
                       device, num_patches: int = 0) -> torch.Tensor:
    """(B, T) positions, or (B, T, 3) for mrope: with ``num_patches``
    patches first, patch i at (0, i // g, i % g) on a g x g grid and text
    token t at (t + g, t + g, t + g); without, (t, t, t)."""
    if cfg.rope == "mrope":
        if num_patches:
            g = max(1, int(num_patches ** 0.5))
            pi = torch.arange(num_patches, device=device)
            patch_pos = torch.stack([torch.zeros_like(pi), pi // g, pi % g],
                                    -1)
            tj = torch.arange(seqlen - num_patches, device=device) + g
            pos = torch.cat([patch_pos, torch.stack([tj, tj, tj], -1)])
        else:
            t = torch.arange(seqlen, device=device)
            pos = torch.stack([t, t, t], -1)
        return pos.expand((batch,) + tuple(pos.shape))
    return torch.arange(seqlen, device=device).expand(batch, seqlen)


def _embed_inputs(params: Params, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor],
                  mi: MeshInfo = MeshInfo()) -> torch.Tensor:
    """Token embeddings, with a vision model's patches (B, P, frontend_dim)
    projected through ``params["frontend"]`` and put before them; an audio
    model's frames (B, T, frontend_dim) through ``params["frontend"]``
    alone.  Frames and patches keep their dtype, so f32 ones make the
    residual stream f32 in a bf16 model, as jnp's promotion does in the
    reference."""
    if cfg.modality == "audio":
        return L.matmul(batch["frames"], params["frontend"])
    if mi.mesh is None:
        x = params["embed"][batch["tokens"]]
    else:
        x = _embed_sharded(mi, params["embed"], batch["tokens"])
    if cfg.modality == "vision" and "patches" in batch:
        patch_emb = L.matmul(batch["patches"], params["frontend"])
        x = torch.cat([patch_emb, x], dim=1)
    return x


def _embed_sharded(mi: MeshInfo, embed, tokens):
    """``embed[tokens]`` with the table's rows (the vocab) sharded over the
    model axis: each model shard looks up the tokens in its rows, zeros
    for the others, and the shards' parts are summed (exact: one
    non-zero part per token)."""
    b = L._bspec(mi)[0]
    tok_spec = P(b, *([None] * (tokens.ndim - 1)))
    out_pl = to_placements(P(b, None, None), mi.mesh)
    va = L.head_axis(mi, embed.shape[0])
    if va is None:
        return region(mi, lambda t, e: e[t], (tokens, embed),
                      (tok_spec, P()), P(b, None, None))

    def lookup(t, e):
        rows = e.shape[0]
        rel = t.long() - mi.axis_index(va) * rows
        ok = (rel >= 0) & (rel < rows)
        return e[rel.clamp(0, rows - 1)] * ok[..., None].to(e.dtype)
    x = region(mi, lookup, (tokens, embed), (tok_spec, P(va, None)),
               partial_on(out_pl, mi.mesh, va))
    return x.redistribute(mi.mesh, out_pl)


def decode_positions(cfg: ModelConfig, cache_len: torch.Tensor
                     ) -> torch.Tensor:
    """A decode step's positions: ``cache_len`` as (B, 1), repeated 3
    times for mrope (B, 1, 3)."""
    positions = cache_len[:, None]
    if cfg.rope == "mrope":
        positions = positions[..., None].expand(cache_len.shape[0], 1, 3)
    return positions


def head_logits(params: Params, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """The final norm, the head (tied or not) and the soft cap."""
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.soft_cap(L.matmul(x, head), cfg.logit_soft_cap)


def forward(
    params: Params,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    *,
    cache: Optional[Params] = None,
    cache_len: Optional[torch.Tensor] = None,   # (B,) context so far
    return_cache: bool = False,
    last_only: bool = False,
    mi: MeshInfo = MeshInfo(),
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (logits, new_cache).  With ``last_only`` the final norm,
    the head and the soft cap take the last position alone and the logits
    are (B, 1, V): the engine's prefill, as the reference's
    ``_prefill_impl`` returns ``logits[:, -1]`` (a 524288-token prompt's
    every row would be 69-268 GB of bf16 logits).

    On a mesh (``mi.mesh``) the parameters, batch and cache are DTensors
    placed by ``repro_torch.models.shardings`` and the activations follow
    DTensor's propagation, the kernels running in local regions
    (``repro_torch.models.layers``).  With grad enabled and no cache,
    ``mi.remat_group`` G > 1 checkpoints every G layers, each layer inside
    checkpointed too (the reference's nested sqrt-L remat).  The layers
    always loop in Python (the reference's ``unroll_layers``).

    decode:  batch["tokens"] has T == 1 and ``cache``/``cache_len`` given;
             the cache is updated in place and returned.
    prefill: full sequence + return_cache=True; a vision model's
             ``batch["patches"]`` come before the tokens (T counts both).

    Decode positions are ``cache_len`` (repeated 3 times for mrope), as in
    ``repro.models.forward``: after P patches on a g-wide grid and T text
    tokens the first decoded token sits at P + T, not at the text's next
    position T + g.
    """
    L.check_supported(cfg)
    x = _embed_inputs(params, cfg, batch, mi)
    B, T = x.shape[0], x.shape[1]
    decoding = cache is not None and T == 1

    if "positions" in batch:
        positions = batch["positions"]
    elif decoding:
        positions = decode_positions(cfg, cache_len)
    else:
        n_patches = (batch["patches"].shape[1]
                     if cfg.modality == "vision" and "patches" in batch
                     else 0)
        positions = _default_positions(cfg, B, T, x.device, n_patches)
        if mi.mesh is not None:
            positions = place(positions, P(L._bspec(mi)[0],
                                           *([None] * (positions.ndim - 1))),
                              mi.mesh)

    remat = torch.is_grad_enabled() and cache is None and not return_cache
    G = mi.remat_group
    blocks = list(zip(params["layers"], _cache_index(cfg)))
    if remat and G > 1 and len(blocks) % G == 0:
        # sqrt-L remat: checkpoints every G layers, each inner layer too
        def group(x, *bps):
            for bp, (kind, _) in bps:
                x, _ = checkpoint(_apply_block, cfg, kind, bp, x, positions,
                                  None, None, False, mi, use_reentrant=False)
            return x
        for g in range(0, len(blocks), G):
            x = checkpoint(group, x, *blocks[g:g + G], use_reentrant=False)
        blocks = []
    new: Dict[str, list] = {}
    for bp, (kind, j) in blocks:
        keys = CACHE_KEYS[kind]
        lc = ({bk: cache[ck][j] for bk, ck in keys.items()} if decoding
              else None)
        if remat:
            x, nc = checkpoint(_apply_block, cfg, kind, bp, x, positions,
                               None, None, False, mi, use_reentrant=False)
        else:
            x, nc = _apply_block(cfg, kind, bp, x, positions, lc, cache_len,
                                 return_cache, mi)
        if return_cache and not decoding:
            for bk, ck in keys.items():
                new.setdefault(ck, []).append(nc[bk])

    if last_only:
        x = x[:, -1:]
    logits = head_logits(params, cfg, x)

    if decoding:
        return logits, cache
    if return_cache:
        return logits, {key: torch.stack(vals) for key, vals in new.items()}
    return logits, None


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #
def _nll_sharded(mi: MeshInfo, logits, labels):
    """The mean next-token NLL of f32 logits (B, T, V) whose vocab shards
    over the model axis, as a replicated DTensor: the log-softmax taken
    shard by shard (Megatron's vocab-parallel cross-entropy; GSPMD
    partitions the reference's the same way): the row max all-reduced
    (max), then each shard's sum of exp(logit - max) and its part of the
    label's logit (zero where the label is another shard's) summed over
    the model axis.  No device holds the whole vocab's logits."""
    b = L._bspec(mi)[0]
    va = L.head_axis(mi, logits.shape[-1])
    l_spec, row = P(b, None, va), to_placements(P(b, None), mi.mesh)
    m = region(mi, lambda x: x.detach().amax(-1), (logits,), (l_spec,),
               partial_on(row, mi.mesh, va, "max")).redistribute(mi.mesh,
                                                                  row)

    def parts(x, m, lab):
        z = x - m[..., None]
        n = x.shape[-1]
        rel = lab.long() - (mi.axis_index(va) * n if va else 0)
        ok = (rel >= 0) & (rel < n)
        pick = torch.gather(z, -1, rel.clamp(0, n - 1)[..., None])[..., 0]
        return z.exp().sum(-1), pick * ok
    summed = partial_on(row, mi.mesh, va)
    se, tgt = region(mi, parts, (logits, m, labels),
                     (l_spec, P(b, None), P(b, None)), [summed, summed])
    ll = tgt.redistribute(mi.mesh, row) - se.redistribute(mi.mesh,
                                                          row).log()
    return (-ll.mean()).redistribute(mi.mesh, to_placements(P(), mi.mesh))


def make_loss_fn(cfg: ModelConfig, mi: MeshInfo = MeshInfo()
                 ) -> Callable[[Params, Dict], torch.Tensor]:
    """Next-token CE for decoders; per-frame label CE for encoders
    (``repro.models.make_loss_fn``): a vision model's patch positions are
    not scored, and the log-softmax is taken in f32.  On a mesh the loss
    is a replicated DTensor."""

    def loss_fn(params: Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        logits, _ = forward(params, cfg, batch, mi=mi)
        labels = batch["labels"]
        if not cfg.is_encoder:
            logits = logits[:, :-1]
            labels = labels[:, 1:]
        if logits.shape[1] != labels.shape[1]:
            # vlm: patches were prepended; score only the text positions
            logits = logits[:, -labels.shape[1]:]
        if mi.mesh is not None:
            return _nll_sharded(mi, logits.float(), labels)
        logp = torch.log_softmax(logits.float(), dim=-1)
        ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
        return -ll.mean()

    return loss_fn
