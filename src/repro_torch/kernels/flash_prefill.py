"""Flash-attention prefill: the Hopper kernels (forward and backward),
their plain versions, their counts.

Replaces the TPU kernel ``flash_prefill`` (``repro/kernels/flash_prefill.py``,
``_flash_kernel``), which the JAX model reaches as ``blockwise_attention``.
The CUDA source is ``csrc/flash_prefill.cu``: one thread block per (q tile,
kv head, batch) holding the G query heads of its kv head, so K/V are never
repeated; the TPU grid's sequential kv axis is a loop over key tiles inside
the block; causal, window, ``q_offset`` and ``k_pos < S`` masks are applied
in the kernel, so ragged T and S need no padded copies.

On the H100 the function is bound by operations (see the note in the CUDA
source).  bf16, the dtype of every served path, runs QK^T and P.V on the
tensor cores with ``wgmma`` (one warpgroup per 64-row tile, Q, K and V
bf16 in shared memory in wgmma's swizzled layout, P from registers, f32
sums) with 64-key K/V tiles copied asynchronously into a 2-stage ring,
heaviest causal q tiles first.  f32, for the models' f32 parity runs and
training, at head_dim 64, 80 (hubert-xlarge), 128 and 256, runs both
products on the tensor cores too, as ``mma.sync`` m16n8k8 TF32 in the
3xTF32 split (each operand x = big + small, both TF32, and small*big +
big*small + big*big summed in f32: ~22 bits of each operand, where one
TF32 pass would miss the f32 limit), one warp per 16 rows, 64-key K/V
tiles (32 at D 256) in a 2-stage ``cp.async`` ring; ``fwd_tiles`` gives
its tiles.  Both can also write each row's f32 log-sum-exp, which the
backward reads, and the bf16 one its output in f32 as well (before the
rounding), from which the backward takes delta = rowsum(dO * O).

The gradient: the JAX package trains by differentiating the jnp attention
its forward calls; here that call is the kernel, so ``FlashPrefillFn``
(a ``torch.autograd.Function``) saves the forward's log-sum-exp and f32
output, and its backward launches ``csrc/flash_prefill_bwd.cu`` (``q_offset`` 0; f32 at D
64 / 80 / 128 / 256, its five products in 3xTF32 on the tensor cores;
bf16 at D 64 / 128 / 256 in ``csrc/flash_prefill_bwd_bf16.cu``, its five
products on ``wgmma`` over 64-row warpgroup tiles with f32 sums; see
``flash_prefill_bwd``).  Inputs without a backward kernel
(bf16 at D 80, which has no bf16 forward either, and a ``q_offset``)
raise when autograd would record them: a bf16 model meets D 80 only in
hubert-xlarge fed bf16 frames, since the reference promotes f32 frames
to an f32 residual stream and the port does as it does.

A row with no valid key returns zeros, as ``repro.kernels.ref`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _meta

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims of the forward and backward kernels by dtype (bf16's wgmma
# layout takes 64-column blocks)
HEAD_DIMS = {torch.float32: (64, 80, 128, 256), torch.bfloat16: (64, 128, 256)}
BWD_HEAD_DIMS = {torch.float32: (64, 80, 128, 256),
                 torch.bfloat16: (64, 128, 256)}
MAX_GROUP = 64            # query heads per kv head in one tile


def rounded_softmax_pv(s, v, pv: str, p_dtype=None):
    """Softmax of the f32 scores ``s`` (-inf where masked) times ``v``,
    with the kernels' rounding: p = exp(s - row max) is rounded to v's
    dtype (or ``p_dtype``) before P.V, while the row sum l adds the
    unrounded p.  A row with no valid key gives zeros.  ``pv`` is the
    einsum of P.V, whose output keeps the score's row as its
    second-to-last axis."""
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum(pv, p.to(p_dtype or v.dtype).float(), v.float())
    return o / torch.where(l > 0, l, 1.0)       # l = 0: o is 0 already


def _scores(q, k, causal, window, q_offset):
    """(B, Hkv, G, T, S) f32 scaled scores, -inf where masked."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k.float()) * (D ** -0.5)
    q_pos = q_offset + torch.arange(T, device=q.device)
    k_pos = torch.arange(S, device=q.device)
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return s.masked_fill(~mask, float("-inf"))


def flash_prefill_plain(q, k, v, *, causal=True, window=0, q_offset=0,
                        return_lse=False):
    """q: (B,T,Hq,D); k,v: (B,S,Hkv,D).  Naive masked softmax attention
    in f32 (the style of ``repro.kernels.ref.flash_prefill_ref``), with p
    rounded to v's dtype before P.V as the Pallas body and the kernel do.
    With ``return_lse`` also each row's f32 log-sum-exp of its scaled
    scores, (B, Hq, T), -inf for a row with no valid key."""
    B, T, Hq, D = q.shape
    s = _scores(q, k, causal, window, q_offset)
    # (B,Hkv,G,T,D) -> (B,T,Hkv,G,D)
    o = rounded_softmax_pv(s, v, "bhgqs,bshd->bhgqd").permute(0, 3, 1, 2, 4)
    o = o.reshape(B, T, Hq, D).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, -1).reshape(B, Hq, T)
    return o


def flash_prefill_plain_chunked(q, k, v, *, causal=True, window=0,
                                q_offset=0, rows=512, return_lse=False):
    """``flash_prefill_plain`` over ``rows`` query rows at a time, each
    chunk against the keys its masks can open (from the first row's
    window start to the last row's causal end) with its own ``q_offset``,
    so that no score matrix is larger than (B, Hq, rows, S): the plain
    version at T = S = 32768, where the whole one would take 137 GB.  The
    same rows, maxima and keys as the unchunked version; the sums run over
    the opened keys only (tests/test_torch_long_context.py)."""
    T, S = q.shape[1], k.shape[1]
    outs, lses = [], []
    for r0 in range(0, T, rows):
        r1 = min(T, r0 + rows)
        p_lo, p_hi = q_offset + r0, q_offset + r1 - 1
        k1 = max(1, min(S, p_hi + 1)) if causal else S
        k0 = max(0, min(p_lo - window + 1, k1 - 1)) if window else 0
        o, lse = flash_prefill_plain(q[:, r0:r1], k[:, k0:k1], v[:, k0:k1],
                                     causal=causal, window=window,
                                     q_offset=p_lo - k0, return_lse=True)
        outs.append(o)
        lses.append(lse)
    o = torch.cat(outs, 1)
    return (o, torch.cat(lses, -1)) if return_lse else o


def flash_prefill_bwd_plain(q, k, v, dout, *, causal=True, window=0):
    """(dq, dk, dv): autograd of ``flash_prefill_plain`` (q_offset 0)."""
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = flash_prefill_plain(qq, kk, vv, causal=causal, window=window)
        return torch.autograd.grad(o, (qq, kk, vv), dout)


def flash_prefill_bwd_plain_chunked(q, k, v, dout, *, causal=True, window=0,
                                    rows=512):
    """``flash_prefill_bwd_plain`` over ``rows`` query rows at a time, each
    chunk differentiated against the keys its masks open (as
    ``flash_prefill_plain_chunked`` takes them), so that no score matrix
    is larger than (B, Hq, rows, S): the plain gradient at T = 16384, where
    the whole one would take 43 GB a score matrix at 40 heads.  Each row's
    dQ comes from its chunk alone; dK and dV are summed over the chunks in
    f32 and rounded to k's dtype once, as the unchunked version rounds its
    f32 sums (tests/test_torch_long_context.py)."""
    B, T, Hq, D = q.shape
    S = k.shape[1]
    dq = torch.empty_like(q)
    dk, dv = (torch.zeros(k.shape, dtype=torch.float32, device=k.device)
              for _ in range(2))
    for r0 in range(0, T, rows):
        r1 = min(T, r0 + rows)
        k1 = max(1, min(S, r1)) if causal else S
        k0 = max(0, min(r0 - window + 1, k1 - 1)) if window else 0
        with torch.enable_grad():
            qq = q[:, r0:r1].detach().requires_grad_()
            kk, vv = (x[:, k0:k1].detach().float().requires_grad_()
                      for x in (k, v))
            s = _scores(qq, kk, causal, window, r0 - k0)
            o = rounded_softmax_pv(s, vv, "bhgqs,bshd->bhgqd", v.dtype)
            o = o.permute(0, 3, 1, 2, 4).reshape(B, r1 - r0, Hq, D)
            gq, gk, gv = torch.autograd.grad(o.to(q.dtype), (qq, kk, vv),
                                             dout[:, r0:r1])
        dq[:, r0:r1] = gq
        dk[:, k0:k1] += gk
        dv[:, k0:k1] += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def fwd_tiles(D: int):
    """(rows a q tile, keys a K/V tile) of the f32 forward kernel at head
    dim D: 8 warps of 16 rows and 64-key tiles; 4 warps and 32-key tiles
    at D 256, where shared memory and registers run out."""
    return (64, 32) if D > 128 else (128, 64)


def bwd_tiles(D: int, dtype=torch.float32):
    """The backward kernel's tiles at head dim D: (rows a dQ tile, keys a
    dQ step, keys a dK/dV tile, rows a dK/dV step).  f32 (8 warps of 16
    rows or keys, ``mma.sync``): 128-row and 128-key tiles, 64 at D 256.
    bf16 (two warpgroups of 64 rows or keys, ``wgmma``): 128-row dQ tiles
    over 64-key steps (32 at D 256), 128-key dK/dV tiles (64 at D 256,
    where both warpgroups take the same keys) over 64-row steps."""
    if dtype == torch.bfloat16:
        return (128, 32, 64, 64) if D > 128 else (128, 64, 128, 64)
    if D > 128:
        return 64, 16, 64, 16
    return 128, 32, 128, 32 if D <= 80 else 16


def bwd_split(B: int, Hkv: int, S: int, D: int, n_sm: int,
              dtype=torch.float32) -> int:
    """Ranges of q tiles that each dK/dV key tile is split over: 1 where
    the dK/dV launch has at least two waves of blocks (n_kt * Hkv * B >=
    2 * n_sm; bf16: one wave, n_sm), else min(4, ceil(2 * n_sm / blocks)).
    The bf16 kernel's blocks are short enough that the third launch costs
    more than a second wave that is nearly full saves (llama3-8b's 256
    blocks on an H100's 132 SMs)."""
    blocks = -(-S // bwd_tiles(D, dtype)[2]) * Hkv * B
    if blocks == 0 or blocks >= (n_sm if dtype == torch.bfloat16 else 2 * n_sm):
        return 1
    return min(4, -(-2 * n_sm // blocks))


def flash_prefill_bwd_tiled_plain(q, k, v, o, dout, lse, *, causal=True,
                                  window=0, n_sm=132, mm=torch.matmul):
    """The backward kernel's own algorithm in plain f32 PyTorch (on f32
    or bf16 inputs), its products through ``mm``: the G query heads of a
    kv head flattened into T*G rows (row t*G + g), P recomputed from
    ``lse`` tile by tile, delta = rowsum(dO*O); dQ summed over the key
    tiles each q tile can see (launch 1); dK and dV over the q tiles that
    can see each key tile (launch 2), split into ``bwd_split(..., n_sm)``
    ranges whose partial sums are added in range order (launch 3); tiles
    (``bwd_tiles`` of q's dtype) and tile ranges chosen as the kernel
    chooses them."""
    B, T, Hq, D = q.shape
    dq_rows, dq_keys, kv_keys, kv_rows = bwd_tiles(D, q.dtype)
    S, Hkv = k.shape[1], k.shape[2]
    G, TG, scale = Hq // Hkv, T * (Hq // Hkv), D ** -0.5

    def rows(x):            # (B,T,Hq,D) -> (B,Hkv,T*G,D)
        return x.float().reshape(B, T, Hkv, G, D).permute(
            0, 2, 1, 3, 4).reshape(B, Hkv, TG, D)

    qf, of, df = rows(q), rows(o), rows(dout)
    kf, vf = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # (B,Hkv,S,D)
    lf = lse.float().reshape(B, Hkv, G, T).transpose(2, 3).reshape(B, Hkv, TG)
    delta = (df * of).sum(-1)
    t_of = torch.arange(TG, device=q.device) // G

    def tile(r0, r1, k0, k1):
        """P and dS of rows [r0, r1) against keys [k0, k1)."""
        t, kp = t_of[r0:r1, None], torch.arange(k0, k1, device=q.device)
        ok = torch.ones((r1 - r0, k1 - k0), dtype=torch.bool,
                        device=q.device)
        if causal:
            ok &= kp <= t
        if window:
            ok &= kp > t - window
        s = mm(qf[:, :, r0:r1], kf[:, :, k0:k1].transpose(-1, -2))
        p = torch.where(ok, torch.exp(s * scale - lf[:, :, r0:r1, None]),
                        0.0)
        dp = mm(df[:, :, r0:r1], vf[:, :, k0:k1].transpose(-1, -2))
        return p, p * (dp - delta[:, :, r0:r1, None])

    dq = torch.zeros_like(qf)
    for r0 in range(0, TG, dq_rows):                # launch 1: dQ
        r1 = min(r0 + dq_rows, TG)
        t_lo, t_hi = r0 // G, (r1 - 1) // G
        k_end = min(S, t_hi + 1) if causal else S
        k_begin = (max(0, t_lo - window + 1) if window else 0) // dq_keys
        for k0 in range(k_begin * dq_keys, k_end, dq_keys):
            k1 = min(k0 + dq_keys, S)
            _, ds = tile(r0, r1, k0, k1)
            dq[:, :, r0:r1] += mm(ds, kf[:, :, k0:k1])
    n_split = bwd_split(B, Hkv, S, D, n_sm, q.dtype)
    dk, dv = (torch.zeros((n_split,) + kf.shape, device=q.device)
              for _ in range(2))
    for k0 in range(0, S, kv_keys):                 # launch 2: dK, dV
        k1 = min(k0 + kv_keys, S)
        t_begin = k0 if causal else 0
        t_end = min(T, k1 - 1 + window) if window else T
        rt_begin = t_begin * G // kv_rows
        n_rt = (-(-t_end * G // kv_rows) - rt_begin if t_end > t_begin
                else 0)
        for sp in range(n_split):
            for rt in range(rt_begin + n_rt * sp // n_split,
                            rt_begin + n_rt * (sp + 1) // n_split):
                r0, r1 = rt * kv_rows, min(rt * kv_rows + kv_rows, TG)
                p, ds = tile(r0, r1, k0, k1)
                dv[sp, :, :, k0:k1] += mm(p.transpose(-1, -2),
                                          df[:, :, r0:r1])
                dk[sp, :, :, k0:k1] += mm(ds.transpose(-1, -2),
                                          qf[:, :, r0:r1])
    for sp in range(1, n_split):                    # launch 3, in order
        dk[0] += dk[sp]
        dv[0] += dv[sp]
    dq = (dq * scale).reshape(B, Hkv, T, G, D).permute(0, 2, 1, 3, 4)
    return (dq.reshape(B, T, Hq, D), (dk[0] * scale).permute(0, 2, 1, 3),
            dv[0].permute(0, 2, 1, 3))


def work(q, k, causal, window, q_offset):
    """((operations, bytes) of the forward, of the backward) at these
    inputs: 4 D a (query, key) pair and head forward, 10 D backward (its
    five products), each input read and each output written once, the
    backward's o and lse in f32 (``chip_smoke.py``'s bounds; the f32 copy
    of its output that a training forward writes in bf16 is not
    counted)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    es = q.element_size()
    pairs = _meta.attention_pairs(T, S, causal, window, q_offset)
    fwd = (4 * D * B * Hq * pairs,
           es * (2 * B * T * Hq * D + 2 * B * S * Hkv * D))
    bwd = (10 * D * B * Hq * pairs,
           es * (3 * B * T * Hq * D + 4 * B * S * Hkv * D)
           + 4 * B * T * Hq * D + 4 * B * Hq * T)
    return fwd, bwd


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q{tuple(q.shape)} does not group over "
                         f"k{tuple(k.shape)}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_cuda(name, tensors, dtypes, head_dims, D, G):
    q = tensors[0]
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError(f"{name}: the tensors must lie on one CUDA device "
                         "(or all on the CPU)")
    if q.dtype not in dtypes or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name}: one dtype of {sorted(map(str, dtypes))}; "
                        f"got {[t.dtype for t in tensors]}")
    if D not in head_dims[q.dtype] or G > MAX_GROUP:
        raise NotImplementedError(
            f"{name} kernel: head_dim in {head_dims[q.dtype]} for {q.dtype} "
            f"and Hq/Hkv <= {MAX_GROUP}; got D={D}, G={G}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{name}: the tensors must be contiguous and "
                         "16-byte aligned (the kernel loads 16 bytes at a "
                         "time)")


def no_backward_reason(dtype, D: int, q_offset: int) -> str:
    """Why ``flash_prefill``'s CUDA kernel has no backward for these
    inputs ("" when it has one)."""
    if dtype not in BWD_HEAD_DIMS:
        return f" for {dtype}"
    if D not in BWD_HEAD_DIMS[dtype]:
        return (f" at head_dim {D} for {dtype} (only "
                f"{BWD_HEAD_DIMS[dtype]})")
    if q_offset:
        return " with a q_offset"
    return ""


def _forward_kernel(q, k, v, causal, window, q_offset, for_grad):
    """Launch the forward kernel on checked CUDA inputs: (out, lse, o) with
    ``for_grad`` (what the backward takes: the rows' log-sum-exp, and the
    output in f32, for bf16 the kernel's f32 values before their rounding),
    else (out, None, None)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = o32 = o = None
    if for_grad:
        lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
        if q.dtype != torch.float32:
            o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        o = out if o32 is None else o32
    if B == 0 or T == 0:
        return out, lse, o
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_prefill_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if for_grad else None,
            None if o32 is None else o32.data_ptr(),
            B, T, S, Hq, Hkv, D, int(bool(causal)), int(window),
            int(q_offset), D ** -0.5, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out, lse, o


class FlashPrefillFn(torch.autograd.Function):
    """``flash_prefill`` with a gradient: the forward launches the kernel
    and saves its log-sum-exp and its output in f32, the backward launches
    the backward kernel (``flash_prefill_bwd``).  CPU tensors take the plain
    versions on both sides."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if _on_cpu(q, k, v):
            out, lse = flash_prefill_plain(q, k, v, causal=causal,
                                           window=window, return_lse=True)
            o = out
        else:
            out, lse, o = _forward_kernel(q, k, v, causal, window, 0, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(q, k, v, out, dout.contiguous(), lse,
                                       causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_prefill(q, k, v, *, causal=True, window=0, q_offset=0):
    """GQA attention of q (B,T,Hq,D) over k, v (B,S,Hkv,D); returns
    (B,T,Hq,D) in q's dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.  Where autograd records the call
    (an input requires grad), a CUDA call goes through ``FlashPrefillFn``
    and its backward kernel, or raises where there is none (bf16 at head
    dim 80, ``q_offset``)."""
    _check(q, k, v)
    if _meta.is_meta(q, k, v):
        return _meta.run("flash_prefill", (q, k, v), [(q.shape, q.dtype)],
                         *work(q, k, causal, window, q_offset))[0]
    if _on_cpu(q, k, v):
        return flash_prefill_plain(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    D, G = q.shape[3], q.shape[2] // k.shape[2]
    _check_cuda("flash_prefill", (q, k, v), _DTYPES, HEAD_DIMS, D, G)
    if _build.wants_grad(q, k, v):
        why = no_backward_reason(q.dtype, D, q_offset)
        if why:
            _build.refuse_grad("flash_prefill", q, k, v, why=why)
        return FlashPrefillFn.apply(q, k, v, bool(causal), int(window))
    return _forward_kernel(q, k, v, causal, window, q_offset, False)[0]


flash_prefill.launches = 0    # kernel launches since the last reset


def flash_prefill_bwd(q, k, v, o, dout, lse, *, causal=True, window=0):
    """The gradient (dq, dk, dv) of ``flash_prefill(q, k, v)`` (q_offset 0)
    from its output ``o`` in f32 (for bf16 inputs the forward kernel's f32
    values before their rounding, ``_forward_kernel(..., for_grad=True)``:
    delta = rowsum(dO * O) from the bf16 output is off by ~2^-9 |dO| |O|,
    a large share of dP - delta in a row with a few keys), the output's
    gradient ``dout`` and the forward's row log-sum-exp ``lse`` (B, Hq, T).
    CPU tensors take the plain version (autograd of
    ``flash_prefill_plain``); CUDA tensors launch
    ``csrc/flash_prefill_bwd.cu`` (f32 at D 64 / 80 / 128 / 256; bf16 at
    D 64 / 128 / 256 in ``csrc/flash_prefill_bwd_bf16.cu``; the gradients
    in the inputs' dtype, ``lse`` f32) or raise."""
    _check(q, k, v)
    B, T, Hq, D = q.shape
    if o.shape != q.shape or dout.shape != q.shape or \
            tuple(lse.shape) != (B, Hq, T):
        raise ValueError(f"flash_prefill_bwd: o{tuple(o.shape)}, "
                         f"dout{tuple(dout.shape)}, lse{tuple(lse.shape)} "
                         f"do not match q{tuple(q.shape)}")
    if _on_cpu(q, k, v, o, dout, lse):
        return flash_prefill_bwd_plain(q, k, v, dout, causal=causal,
                                       window=window)
    S, Hkv = k.shape[1], k.shape[2]
    _check_cuda("flash_prefill_bwd", (q, k, v, dout), _DTYPES,
                BWD_HEAD_DIMS, D, Hq // Hkv)
    for name, x in (("o", o), ("lse", lse)):
        if not (x.device == q.device and x.dtype == torch.float32
                and x.is_contiguous() and x.data_ptr() % 16 == 0):
            raise ValueError(f"flash_prefill_bwd: {name} must be a "
                             "contiguous, 16-byte aligned f32 tensor on q's "
                             "device")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if B == 0:
        return dq, dk, dv
    delta = torch.empty_like(lse)       # scratch: rowsum(dO * O)
    n_split = bwd_split(B, Hkv, S, D, torch.cuda.get_device_properties(
        q.device).multi_processor_count, q.dtype)
    # scratch: the dK/dV launch's partial sums where it is split
    part = (torch.empty((2, n_split) + tuple(k.shape), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    lib = _build.load()
    with torch.cuda.device(q.device):
        bf16 = q.dtype == torch.bfloat16
        err = lib.flash_prefill_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bf16 else o.data_ptr(), o.data_ptr() if bf16 else None,
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), B, T, S, Hq, Hkv,
            D, int(bool(causal)), int(window), n_split, D ** -0.5,
            _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_prefill_bwd")
    flash_prefill_bwd.launches += 1
    return dq, dk, dv


flash_prefill_bwd.launches = 0    # kernel launches since the last reset
