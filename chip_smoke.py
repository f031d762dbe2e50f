#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases build,kernels,parity,serve]

Phases, in order (all by default):

1. ``nvidia-smi``: the card's name and power limit.
2. ``build``: compile ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``
   into the git-ignored ``build/kernels/`` and load the library.
3. ``kernels``: each hand-written kernel against its plain PyTorch version
   on the card: the attention kernels in bf16 and f32, over ragged
   lengths, T and S that are not multiples of the tiles, GQA groups of 1,
   4, 5 and 10, head_dim 64, 128 and 256 (recurrentgemma-2b's shapes, with
   windowed prefills past and off its tiles and a decode over a full ring);
   the split-S decode also against its own algorithm in plain PyTorch
   (``decode_attention_split_plain``), at lengths 0, 1, on a split
   boundary and one either side of it, and with S off the split size;
   ``rwkv6_scan`` in f32 (o and final state) over ragged T, D 64 and 128,
   a carried-in state, and fast decays against a step-by-step recurrence
   (there the plain chunked form overflows); ``rglru_scan`` in f32 over
   ragged T and d, a carried-in h0 and strong decays.  Prints the error
   against the tolerance and the kernel's, the plain version's and (for
   attention) ``scaled_dot_product_attention``'s times beside the least
   time the card could take (``bound_ms``).  ``ms``, ``plain_ms`` and
   ``library_ms`` are means of back-to-back calls, host launch overhead
   included where a call is shorter on the card than on the host;
   ``device_ms`` and ``library_device_ms`` time the same calls behind a
   GPU spin that fills the queue first, so they are device time alone,
   and give the achieved TFLOP/s (prefill) or GB/s (decode; also timed
   with the L2 cache flushed before each call).
4. ``parity``: llama3-8b and rwkv6-3b at full width, 2 layers, and
   recurrentgemma-2b at full width, 3 layers (one RG-LRU, RG-LRU, local
   attention cycle), f32: one prompt and 8 greedy decode steps with the
   kernels on the card and with the plain versions on the CPU; logits
   within a stated tolerance, tokens equal.  A second recurrentgemma-2b
   run has its window reduced to 128 under a 190-token prompt, so that
   the prefill's ring is rolled and decode wraps it.
5. ``serve``: the main paths.  ``PaDGServer(backend="real")`` serves 16
   requests on two instances of full-depth bf16 llama3-8b, then of
   rwkv6-3b, then of recurrentgemma-2b (``max_batch`` 8, ``max_seq_len``
   2048), on a wall clock; every request must finish with its token
   count, no logit row may hold a NaN or an infinity, and the launch
   counts of the path's kernels (all set to 0 just before each run, read
   just after it) must be > 0.

Every failure exits non-zero; without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, the script exits
non-zero before printing any result.  The line before the last is the
kernel table as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("build", "kernels", "parity", "serve")

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside them
# (the kernels do f32 products as IEEE FMAs, never TF32), HBM3 rate.
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# |kernel - plain| <= atol + atol_rms * rms(plain) + rtol * |plain| per
# element, for both kernels.  Both sides round p to the input dtype before
# P.V, so they differ by the order of sums and, in bf16, by the one
# rounding of the output (one bf16 step, at most 2**-7 of |plain|) and by
# where p meets its rounding (the kernel rounds against a running row
# max; up to another step on rows with few keys): two steps in all
TOL = {"float32": dict(atol=2e-5, atol_rms=0.0, rtol=2e-5),
       "bfloat16": dict(atol=0.0, atol_rms=1e-2, rtol=2.0 ** -6)}
# rwkv6_scan (f32) against its plain version: both sum T*D-term products in
# f32, the kernel over 64-step chunks with its decays factored into terms
# <= 1, the plain version over 128-step chunks as rwkv6_chunked_jnp; so the
# error scales with the output's size (1e-4 of its rms), a tenth of the
# reference tests' 1e-3 (tests/test_kernels.py) on outputs of about 1
TOL["rwkv6"] = dict(atol=0.0, atol_rms=1e-4, rtol=1e-4)
# rglru_scan (f32) against its plain version: both run the same step-by-step
# recurrence with two roundings a step, so they differ only where the
# card's expf and torch's exp differ; a tenth of the reference tests' 1e-4
TOL["rglru"] = dict(atol=1e-5, atol_rms=0.0, rtol=1e-5)
# model parity, f32 logits: cuBLAS and the kernels sum 2560- to 14336-long
# products (and rwkv6_scan its T*D-term sums) in another order than the CPU
PARITY_ATOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# GPU clock cycles of the spin that fills the queue before a timed run with
# spin=True (about 5 ms at the H100's clocks): the host enqueues every
# timed call while the card spins, so the events see device time, not the
# host's launch overhead (a decode call is shorter on the card than on the
# host)
SPIN_CYCLES = 10_000_000


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3,
            spin: bool = False) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls on CUDA
    events: with the host's launch overhead wherever a call is shorter on
    the card than on the host, or with ``spin`` the device time alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def cuda_ms_cold(torch, fn, flush, iters: int = 20) -> float:
    """Mean device time of ``fn`` with the L2 cache flushed before each
    call (``flush`` is a device buffer larger than the 50 MB L2), as a
    decode step finds it after the layer's weights went through."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    torch.cuda._sleep(SPIN_CYCLES)
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound(nbytes: float, ops: float, dtype_name: str):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of the inputs' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, tol_name: str):
    """(ok, max |got - want|, largest share of its limit an element uses)."""
    tol = TOL[tol_name]
    want = want.float()
    diff = (got.float() - want).abs()
    limit = (tol["atol"] + tol["atol_rms"] * want.square().mean().sqrt()
             + tol["rtol"] * want.abs())
    max_abs = float(diff.max()) if diff.numel() else 0.0
    share = float((diff / limit).max()) if diff.numel() else 0.0
    ok = bool(torch.isfinite(got).all()) and share <= 1.0
    return ok, max_abs, share


def tol_text(tol_name: str) -> str:
    t = TOL[tol_name]
    return (f"tol {t['atol']:g} + {t['atol_rms']:g}*rms + "
            f"{t['rtol']:.4g}*|plain|")


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #
# The first element names the served path whose main shape the case is (its
# bf16 line goes into the kernel table), or is None.
FLASH_CASES = [  # path, B, T, S, Hq, Hkv, D, causal, window, q_offset
    ("llama3-8b", 1, 1024, 1024, 32, 8, 128, True, 0, 0),
    (None, 1, 1000, 1000, 32, 8, 128, True, 0, 0),  # T, S not tile multiples
    (None, 2, 200, 200, 10, 2, 128, True, 0, 0),    # G = 5
    (None, 2, 128, 128, 8, 2, 64, True, 0, 0),      # D = 64
    (None, 1, 64, 190, 4, 2, 64, True, 0, 126),     # chunked prefill offset
    (None, 1, 160, 160, 4, 2, 64, True, 32, 0),     # sliding window
    (None, 1, 128, 100, 4, 4, 64, False, 0, 0),     # bidirectional, S != T
    # recurrentgemma-2b's local attention: G = 10, D = 256, its 2048 window
    # (inactive below 2048 tokens), then a prefill past a 128 window
    ("recurrentgemma-2b", 1, 1024, 1024, 10, 1, 256, True, 2048, 0),
    (None, 1, 1000, 1000, 10, 1, 256, True, 128, 0),
    # T and S off the bf16 kernel's 64-key tiles and its 64/G-position
    # q tiles; G = 1 (64 positions a tile, one left over); a
    # window that is no tile multiple and a chunked prefill past a window,
    # both at G = 10, D = 256
    (None, 1, 333, 333, 32, 8, 128, True, 0, 0),
    (None, 2, 65, 65, 4, 4, 64, True, 0, 0),
    (None, 1, 700, 700, 10, 1, 256, True, 100, 0),
    (None, 1, 100, 1100, 10, 1, 256, True, 300, 1000),
]
DECODE_CASES = [  # path, B, S, Hq, Hkv, D, lengths (a count or a kind)
    ("llama3-8b", 8, 2048, 32, 8, 128, 1024),
    (None, 8, 2048, 32, 8, 128, "ragged"),
    (None, 4, 1000, 4, 4, 128, "ragged"),           # S not a tile multiple
    (None, 1, 512, 10, 2, 64, "ragged"),            # G = 5
    (None, 2, 256, 8, 2, 64, "ragged"),
    # recurrentgemma-2b: a W = 2048 ring half full, then full (every slot
    # valid, as after a wrap), then ragged
    ("recurrentgemma-2b", 8, 2048, 10, 1, 256, 1024),
    (None, 8, 2048, 10, 1, 256, 2048),
    (None, 4, 1000, 10, 1, 256, "ragged"),
    # split-S: B 1 and Hkv 1 (the most splits per sequence) with one key;
    # lengths 0, 1, on a split boundary r and r +- 1, 2r; S no multiple
    # of the split (lengths S, S - 1, on the last boundary, 1)
    (None, 1, 2048, 10, 1, 256, 1),
    (None, 6, 2048, 8, 1, 128, "edges"),
    (None, 6, 2048, 10, 1, 256, "edges"),
    (None, 4, 1000, 10, 1, 256, "tail"),
    (None, 4, 1000, 4, 2, 64, "tail"),
]


def decode_lengths(rng, lens, B, S, rows):
    """The per-sequence lengths of a decode case; ``rows`` is the kernel's
    split size at this shape."""
    if lens == "ragged":
        out = rng.integers(1, S + 1, B)
        out[0] = 1                               # a fresh slot's one key
        return [int(x) for x in out]
    if lens == "edges":
        return [0, 1, rows - 1, rows, rows + 1, 2 * rows][:B]
    if lens == "tail":
        return [S, S - 1, (S // rows) * rows, 1][:B]
    return [lens] * B


def flash_pairs(T, S, causal, window, q_offset) -> int:
    """(query, key) pairs the masks leave open, per head."""
    n = 0
    for i in range(T):
        p = q_offset + i
        hi = min(S - 1, p) if causal else S - 1
        lo = max(0, p - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def sdpa_mask(torch, T, S, causal, window, q_offset, device):
    qp = q_offset + torch.arange(T, device=device)[:, None]
    kp = torch.arange(S, device=device)[None, :]
    m = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        m &= kp <= qp
    if window:
        m &= kp > qp - window
    return m


def record(results, name, path, **numbers):
    """Keep a kernel's numbers at a served path's main shape."""
    if path is not None:
        results.setdefault(name, {})[path] = numbers


def run_kernels(torch, rng, results):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_prefill as FP

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def randn(shape, dtype):
        x = rng.standard_normal(shape, "float32")
        return torch.from_numpy(x).to(dev, dtype)

    all_ok = True
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        esize = torch.finfo(dtype).bits // 8
        for case in FLASH_CASES:
            path, B, T, S, Hq, Hkv, D, causal, window, off = case
            q = randn((B, T, Hq, D), dtype)
            k = randn((B, S, Hkv, D), dtype)
            v = randn((B, S, Hkv, D), dtype)
            kw = dict(causal=causal, window=window, q_offset=off)
            got = FP.flash_prefill(q, k, v, **kw)
            want = FP.flash_prefill_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            ok, err, share = compare(torch, got, want, dn)
            kern = lambda: FP.flash_prefill(q, k, v, **kw)  # noqa: E731
            ms, dev_ms = cuda_ms(torch, kern), cuda_ms(torch, kern, spin=True)
            plain_ms = cuda_ms(
                torch, lambda: FP.flash_prefill_plain(q, k, v, **kw))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            # (a window that no query position reaches masks nothing)
            if causal and not off and S == T and (not window
                                                  or window >= T):
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            else:
                mask = sdpa_mask(torch, T, S, causal, window, off, dev)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
            lib_ms, lib_dev_ms = cuda_ms(torch, lib), cuda_ms(torch, lib,
                                                              spin=True)
            nbytes = esize * (2 * B * T * Hq * D + 2 * B * S * Hkv * D)
            ops = 4 * D * B * Hq * flash_pairs(T, S, causal, window, off)
            b_ms, b_by = bound(nbytes, ops, dn)
            all_ok &= ok
            log(f"flash_prefill {dn} B={B} T={T} S={S} Hq={Hq} Hkv={Hkv} "
                f"D={D} causal={causal} window={window} q_offset={off}: "
                f"max_abs_err={err:.3e} ({tol_text(dn)}; worst element at "
                f"{share:.3f} of its limit) "
                f"{'ok' if ok else 'MISMATCH'} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"(device: kernel {dev_ms:.4f}, library {lib_dev_ms:.4f}) "
                f"bound_ms={b_ms:.4f} ({b_by}) achieved on the device "
                f"{ops / dev_ms * 1e-9:.1f} TFLOP/s (SDPA "
                f"{ops / lib_dev_ms * 1e-9:.1f})")
            if dtype == torch.bfloat16:
                record(results, "flash_prefill", path, max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                       library_device_ms=lib_dev_ms)
        for case in DECODE_CASES:
            path, B, S, Hq, Hkv, D, lens = case
            q = randn((B, Hq, D), dtype)
            kc = randn((B, S, Hkv, D), dtype)
            vc = randn((B, S, Hkv, D), dtype)
            rows = DA.split_rows(B, Hkv, S, n_sm)
            lengths = decode_lengths(rng, lens, B, S, rows)
            ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
            got = DA.decode_attention(q, kc, vc, ln)
            want = DA.decode_attention_plain(q, kc, vc, ln)
            # the kernel's own algorithm: the same splits, combined in order
            want_split = DA.decode_attention_split_plain(q, kc, vc, ln, rows)
            torch.cuda.synchronize()
            ok, err, share = compare(torch, got, want, dn)
            ok_s, err_s, share_s = compare(torch, got, want_split, dn)
            ok &= ok_s
            kern = lambda: DA.decode_attention(q, kc, vc, ln)  # noqa: E731
            ms, dev_ms = cuda_ms(torch, kern), cuda_ms(torch, kern, spin=True)
            plain_ms = cuda_ms(
                torch, lambda: DA.decode_attention_plain(q, kc, vc, ln))
            mask = torch.arange(S, device=dev)[None] < ln[:, None]
            mask = mask[:, None, None]
            qt = q[:, :, None]
            kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
            lib_ms, lib_dev_ms = cuda_ms(torch, lib), cuda_ms(torch, lib,
                                                              spin=True)
            cold_ms = cuda_ms_cold(torch, kern, flush)
            lib_cold_ms = cuda_ms_cold(torch, lib, flush)
            n_valid = int(sum(int(x) for x in lengths))
            nbytes = esize * (2 * B * Hq * D + 2 * n_valid * Hkv * D) + 4 * B
            ops = 4 * Hq * D * n_valid
            b_ms, b_by = bound(nbytes, ops, dn)
            all_ok &= ok
            shown = lens if isinstance(lens, int) else f"{lens} {lengths}"
            log(f"decode_attention {dn} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                f"lengths={shown} (sum {n_valid}), {-(-S // rows)} splits of "
                f"{rows}: max_abs_err={err:.3e} ({tol_text(dn)}; worst "
                f"element at {share:.3f} of its limit; against the split "
                f"plain version {err_s:.3e}, {share_s:.3f}) "
                f"{'ok' if ok else 'MISMATCH'} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"(device: kernel {dev_ms:.4f}, library {lib_dev_ms:.4f}) "
                f"bound_ms={b_ms:.4f} ({b_by}) achieved on the device "
                f"{nbytes / dev_ms * 1e-6:.1f} GB/s (SDPA "
                f"{nbytes / lib_dev_ms * 1e-6:.1f}); device, L2 flushed "
                f"before each call: kernel {cold_ms:.4f} ms, SDPA "
                f"{lib_cold_ms:.4f} ms")
            if dtype == torch.bfloat16:
                record(results, "decode_attention", path, max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                       library_device_ms=lib_dev_ms)
    all_ok &= run_rwkv6_kernel(torch, rng, results)
    all_ok &= run_rglru_kernel(torch, rng, results)
    if not all_ok:
        fail("a kernel disagrees with its plain version (lines above)")


RWKV_CASES = [  # B, T, H, D, carried-in state, decay
    (1, 1024, 40, 64, False, "slow"),           # rwkv6-3b prefill (main)
    (1, 1000, 40, 64, False, "slow"),           # T not a chunk multiple
    (1, 190, 40, 64, False, "slow"),            # a short ragged prompt
    (2, 300, 8, 64, True, "slow"),              # s0 carried in
    (1, 256, 8, 128, False, "slow"),            # D = 128
    (1, 190, 4, 64, True, "fast"),              # plain form overflows
]
RWKV_KERNEL_CHUNK = 64      # chunk of csrc/rwkv6_scan.cu


def rwkv6_ops(B, T, H, D) -> int:
    """f32 operations of the chunked WKV6 at the kernel's chunk on these T
    steps: per step and head 2 D^2 for the carried state's output and 2 D^2
    for the state update; per causal (t, s) pair of a chunk, s <= t, 2 D
    for the score and 2 D for A.V."""
    c = RWKV_KERNEL_CHUNK
    full, rest = divmod(T, c)
    pairs = full * c * (c + 1) // 2 + rest * (rest + 1) // 2
    return B * H * (4 * D * D * T + 4 * D * pairs)


def wkv6_steps(torch, r, k, v, w, u, s0):
    """The recurrence one step at a time (``repro.kernels.ref.rwkv6_ref``):
    an oracle that stays finite at any decay."""
    B, T, H, D = r.shape
    S = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if s0 is None else s0.clone())
    outs = []
    for t in range(T):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        o = (rt * u * kt).sum(-1, keepdim=True) * vt
        outs.append(o + torch.einsum("bhd,bhde->bhe", rt, S))
        S = S * w[:, t][..., None] + kt[..., None] * vt[..., None, :]
    return torch.stack(outs, dim=1), S


def run_rwkv6_kernel(torch, rng, results) -> bool:
    from repro_torch.kernels import rwkv6_scan as RS

    dev = torch.device("cuda")

    def arr(x):
        return torch.from_numpy(x.astype("float32")).to(dev)

    all_ok = True
    for case in RWKV_CASES:
        B, T, H, D, carried, decay = case
        shape = (B, T, H, D)
        # the inputs of tests/test_kernels.py's rwkv6 cases; "fast" decays
        # put a 128-step chunk's log-decay sum near -500
        r, k, v = (arr(rng.standard_normal(shape) * 0.5) for _ in range(3))
        lo, hi = (0.6, 0.999) if decay == "slow" else (1e-3, 0.05)
        w = arr(rng.uniform(lo, hi, shape))
        u = arr(rng.standard_normal((H, D)) * 0.1)
        s0 = arr(rng.standard_normal((B, H, D, D))) if carried else None
        o, st = RS.rwkv6_scan(r, k, v, w, u, s0)
        p_o, p_st = RS.rwkv6_scan_plain(r, k, v, w, u, s0)
        if decay == "fast":
            plain_finite = bool(torch.isfinite(p_o).all())
            p_o, p_st = wkv6_steps(torch, r, k, v, w, u, s0)
        torch.cuda.synchronize()
        ok_o, err_o, share_o = compare(torch, o, p_o, "rwkv6")
        ok_s, err_s, share_s = compare(torch, st, p_st, "rwkv6")
        kern = lambda: RS.rwkv6_scan(r, k, v, w, u, s0)  # noqa: E731
        ms, dev_ms = cuda_ms(torch, kern), cuda_ms(torch, kern, spin=True)
        plain_ms = cuda_ms(torch,
                           lambda: RS.rwkv6_scan_plain(r, k, v, w, u, s0))
        nbytes = 4 * (5 * B * T * H * D + H * D
                      + (2 if carried else 1) * B * H * D * D)
        b_ms, b_by = bound(nbytes, rwkv6_ops(B, T, H, D), "float32")
        ok = ok_o and ok_s
        all_ok &= ok
        against = ("plain" if decay == "slow" else "step-by-step recurrence;"
                   f" plain chunked form finite: {plain_finite}")
        log(f"rwkv6_scan float32 B={B} T={T} H={H} D={D} s0={carried} "
            f"decay={decay} (against {against}): o max_abs_err={err_o:.3e}"
            f" (worst element at {share_o:.3f} of its limit), state "
            f"max_abs_err={err_s:.3e} ({share_s:.3f}) ({tol_text('rwkv6')})"
            f" {'ok' if ok else 'MISMATCH'} kernel_ms={ms:.4f} (device "
            f"{dev_ms:.4f}) plain_ms={plain_ms:.4f} library_ms=null (no "
            f"single PyTorch call computes WKV6) bound_ms={b_ms:.4f} "
            f"({b_by})")
        if case is RWKV_CASES[0]:
            record(results, "rwkv6_scan", "rwkv6-3b",
                   max_abs_err=max(err_o, err_s), ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   device_ms=dev_ms, library_device_ms=None)
    return all_ok


RGLRU_CASES = [  # B, T, d, carried-in h0, decay
    (1, 1024, 2560, False, "model"),    # recurrentgemma-2b prefill (main)
    (1, 1000, 2560, False, "model"),    # T not a multiple of the kernel's 16
    (1, 190, 2560, False, "model"),     # a short ragged prompt
    (1, 256, 96, False, "model"),       # d not a multiple of a block's 64
    (2, 300, 2560, True, "model"),      # h0 carried in
    (1, 190, 2560, True, "strong"),     # log_a near -10: h is almost b
]


def run_rglru_kernel(torch, rng, results) -> bool:
    import numpy as np

    from repro_torch.kernels import rglru_scan as RG

    dev = torch.device("cuda")

    def arr(x):
        return torch.from_numpy(x.astype("float32")).to(dev)

    all_ok = True
    for case in RGLRU_CASES:
        B, T, d, carried, decay = case
        shape = (B, T, d)
        if decay == "model":
            # the model's range: log_a = -8 softplus(1) sigmoid(.) in
            # (-10.5, 0), b = sqrt(1 - a^2) times a gated input
            gate = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))
            log_a = -8.0 * np.log1p(np.e) * gate
        else:
            log_a = rng.uniform(-10.5, -9.5, shape)
        b = (np.sqrt(np.maximum(1.0 - np.exp(2.0 * log_a), 1e-12))
             * rng.standard_normal(shape))
        la, bb = arr(log_a), arr(b)
        h0 = arr(rng.standard_normal((B, d))) if carried else None
        got = RG.rglru_scan(la, bb, h0)
        want = RG.rglru_scan_plain(la, bb, h0)
        torch.cuda.synchronize()
        ok, err, share = compare(torch, got, want, "rglru")
        kern = lambda: RG.rglru_scan(la, bb, h0)  # noqa: E731
        ms, dev_ms = cuda_ms(torch, kern), cuda_ms(torch, kern, spin=True)
        plain_ms = cuda_ms(torch, lambda: RG.rglru_scan_plain(la, bb, h0),
                           iters=3, warmup=1)
        nbytes = 4 * (3 * B * T * d + (B * d if carried else 0))
        # per element: one exp, one product, one sum
        b_ms, b_by = bound(nbytes, 3 * B * T * d, "float32")
        all_ok &= ok
        log(f"rglru_scan float32 B={B} T={T} d={d} h0={carried} "
            f"decay={decay}: max_abs_err={err:.3e} ({tol_text('rglru')}; "
            f"worst element at {share:.3f} of its limit) "
            f"{'ok' if ok else 'MISMATCH'} kernel_ms={ms:.4f} (device "
            f"{dev_ms:.4f}) plain_ms={plain_ms:.4f} library_ms=null (no "
            f"single PyTorch call computes this scan) bound_ms={b_ms:.4f} "
            f"({b_by})")
        if case is RGLRU_CASES[0]:
            record(results, "rglru_scan", "recurrentgemma-2b",
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, device_ms=dev_ms,
                   library_device_ms=None)
    return all_ok


# --------------------------------------------------------------------- #
# phase 4: model parity, kernels on the card vs plain versions on the CPU
# --------------------------------------------------------------------- #
def greedy(torch, params, cfg, prompt, n_new, device):
    from repro_torch.models import forward, init_cache, write_slot

    T = len(prompt)
    toks = torch.tensor([prompt], dtype=torch.long, device=device)
    logits, pc = forward(params, cfg, {"tokens": toks}, return_cache=True)
    cache = init_cache(cfg, 1, T + n_new + 1, torch.float32, device)
    write_slot(cache, pc, 0, T)
    steps = [logits[0, -1].cpu()]
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out = [int(tok)]
    for i in range(n_new):
        cl = torch.tensor([T + i], dtype=torch.int32, device=device)
        logits, cache = forward(params, cfg, {"tokens": tok}, cache=cache,
                                cache_len=cl)
        steps.append(logits[0, 0].cpu())
        tok = logits[:, 0].argmax(-1, keepdim=True)
        out.append(int(tok))
    return out, torch.stack(steps)


# prompt lengths of the parity runs: llama3-8b as before; rwkv6-3b's is
# ragged against both the kernel's 64-step and the plain form's 128-step
# chunks, recurrentgemma-2b's against rglru_scan's 16-step chunks and
# flash_prefill's 6-position query tiles
PARITY_PROMPT = {"llama3-8b": 77, "rwkv6-3b": 190, "recurrentgemma-2b": 190}
# layers of the parity runs: 2, or recurrentgemma-2b's one full (RG-LRU,
# RG-LRU, local attention) cycle
PARITY_LAYERS = {"recurrentgemma-2b": 3}
# (arch, reduced sliding window or None): the second recurrentgemma-2b run
# cuts the window to 128 under its 190-token prompt, so the prefill rolls
# the ring and decode wraps it on the card
PARITY_RUNS = [("llama3-8b", None), ("rwkv6-3b", None),
               ("recurrentgemma-2b", None), ("recurrentgemma-2b", 128)]


def run_parity(torch, rng, seed, arch, window=None):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    n_layers = PARITY_LAYERS.get(arch, 2)
    cfg = dataclasses.replace(get_config(arch), num_layers=n_layers)
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p_gpu = init_params(cfg, gen, torch.float32, "cuda")

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    p_cpu = to_cpu(p_gpu)
    n = PARITY_PROMPT[arch]
    prompt = [int(x) for x in rng.integers(2, cfg.vocab_size - 1, n)]
    t0 = time.perf_counter()
    tok_gpu, lg_gpu = greedy(torch, p_gpu, cfg, prompt, 8, "cuda")
    t_gpu = time.perf_counter() - t0
    # the first torch.exp of a CPU process can come out less accurate on
    # part of its tensor (ROADMAP Queue 3): one call before the reference
    torch.exp(torch.zeros(64))
    t0 = time.perf_counter()
    tok_cpu, lg_cpu = greedy(torch, p_cpu, cfg, prompt, 8, "cpu")
    t_cpu = time.perf_counter() - t0
    err = float((lg_gpu - lg_cpu).abs().max())
    reduced = (f", window reduced to {window} (reduced run)" if window
               else "")
    log(f"parity {arch} width, {n_layers} layers{reduced}, f32, prompt {n} "
        f"+ 8 decode steps: max |logit diff| = {err:.3e} (tol "
        f"{PARITY_ATOL}), "
        f"logit range [{float(lg_cpu.min()):.2f}, {float(lg_cpu.max()):.2f}]"
        f"; tokens card {tok_gpu} cpu {tok_cpu}; card {t_gpu:.2f} s, "
        f"cpu {t_cpu:.2f} s (host clock)")
    if not (torch.isfinite(lg_gpu).all() and err <= PARITY_ATOL):
        fail(f"{arch} parity: logits differ by {err:.3e} > {PARITY_ATOL}")
    if tok_gpu != tok_cpu:
        fail(f"{arch} parity: greedy tokens differ between card and CPU")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 5: serve (the main path)
# --------------------------------------------------------------------- #
class StepLog:
    """The engines' ``recorder`` hook: host time of each prefill and
    decode step, taken after the step's argmax read (so device time)."""

    def __init__(self):
        self.prefill, self.decode = [], []

    def record_prefill(self, tokens, dt):
        self.prefill.append((tokens, dt))

    def record_decode(self, batch, ctx_sum, dt):
        self.decode.append((batch, ctx_sum, dt))

    def summary(self, np) -> str:
        ptoks = np.array([t for t, _ in self.prefill])
        pdt = np.array([dt for _, dt in self.prefill]) * 1e3
        batch = np.array([b for b, _, _ in self.decode])
        ddt = np.array([dt for _, _, dt in self.decode]) * 1e3
        full = ddt[batch == batch.max()]
        return (f"prefills {len(pdt)}: median {np.median(pdt):.2f} ms, "
                f"median {np.median(pdt / ptoks * 1e3):.2f} ms per 1000 "
                f"tokens; decode steps {len(ddt)}: median {np.median(ddt):.2f}"
                f" ms, p90 {np.percentile(ddt, 90):.2f} ms, median batch "
                f"{np.median(batch):.0f}, at batch {batch.max()} "
                f"({len(full)} steps) median {np.median(full):.2f} ms")


# the kernels each served architecture's path must launch
PATH_KERNELS = {"llama3-8b": ("flash_prefill", "decode_attention"),
                "rwkv6-3b": ("rwkv6_scan",),
                "recurrentgemma-2b": ("rglru_scan", "flash_prefill",
                                      "decode_attention")}


def kernel_wrappers():
    """name -> the wrapper that carries the kernel's launch count."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    return {"flash_prefill": flash_prefill,
            "decode_attention": decode_attention,
            "rwkv6_scan": rwkv6_scan, "rglru_scan": rglru_scan}


def run_serve(torch, rng, seed, arch):
    import numpy as np

    import repro_torch.serving.engine as engine_mod
    from repro_torch.configs import get_config
    from repro_torch.core.request import Request
    from repro_torch.core.slo import SLO
    from repro_torch.serving.padg_server import PaDGServer
    from repro_torch.serving.replay import WallClock

    cfg = get_config(arch)
    econf = engine_mod.EngineConfig(max_batch=8, max_seq_len=2048,
                                    dtype=torch.bfloat16, eos_token=-1,
                                    device="cuda")
    # arrivals and lengths first, so that every path serves the same trace
    # (how many draws the tokens take depends on the vocabulary's size)
    shape, t = [], 0.0
    for i in range(16):
        shape.append((t, int(rng.integers(128, 1025)),
                      int(rng.integers(16, 65))))
        t += float(rng.exponential(1.0 / 4.0))
    reqs = [Request(rid=i, arrival_time=t, prompt_len=plen, output_len=out,
                    prompt_tokens=[int(x) for x in
                                   rng.integers(2, cfg.vocab_size - 1, plen)])
            for i, (t, plen, out) in enumerate(shape)]

    # count non-finite logits on the device, read once after the run; the
    # last position's row of every slot, the one the engine takes its
    # argmax of (two small device ops per step beside the model's
    # thousands)
    nonfinite = torch.zeros((), dtype=torch.int64, device="cuda")
    real_forward = engine_mod.forward

    def checked_forward(*args, **kwargs):
        logits, cache = real_forward(*args, **kwargs)
        nonfinite.add_((~torch.isfinite(logits[:, -1])).sum())
        return logits, cache

    wrappers = kernel_wrappers()
    engine_mod.forward = checked_forward
    try:
        t0 = time.perf_counter()
        gc.collect()          # an earlier serve's engines, cycles included
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        steps = StepLog()
        with PaDGServer(cfg, n_instances=2, slo=SLO(ttft=60.0, tpot=10.0),
                        econf=econf, seed=seed, recorder=steps) as server:
            t_init = time.perf_counter() - t0
            for fn in wrappers.values():
                fn.launches = 0
            t0 = time.perf_counter()
            stats = server.serve(reqs, clock=WallClock(1.0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in wrappers.items()}
        del server
    finally:
        engine_mod.forward = real_forward
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    summary = stats.summary()
    log(f"serve {arch} bf16, {cfg.num_layers} layers, "
        f"{cfg.param_count() / 1e9:.2f}B parameters, 2 instances, max_batch"
        f" 8, max_seq_len 2048: {len(reqs)} requests, prompts "
        f"{sum(r.prompt_len for r in reqs)} tokens, outputs "
        f"{sum(r.output_len for r in reqs)} tokens")
    log(f"serve {arch} summary {json.dumps(summary)}")
    log(f"serve {arch} wall_s={wall:.2f} (host clock) init_s={t_init:.2f} "
        f"peak_device_gb={peak_gb:.2f} launches={json.dumps(launches)}")
    log(f"serve {arch} steps (host clock): {steps.summary(np)}")
    n_bad = int(nonfinite)
    if n_bad:
        fail(f"serve {arch}: {n_bad} non-finite logits")
    if summary["finished"] != len(reqs) or stats.rejected:
        fail(f"serve {arch}: {summary['finished']} of {len(reqs)} finished")
    short = [r.rid for r in stats.finished
             if len(r.generated) != r.output_len]
    if short:
        fail(f"serve {arch}: requests {short} lack tokens")
    for name in PATH_KERNELS[arch]:
        if launches[name] <= 0:
            fail(f"serve {arch}: kernel {name} was never launched on its "
                 "path")
    return {name: launches[name] for name in PATH_KERNELS[arch]}


# --------------------------------------------------------------------- #
KERNEL_META = {
    "flash_prefill": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill.py:82"),
    "decode_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:64"),
    "rwkv6_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:71"),
    "rglru_scan": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:47"),
}
NUMBER_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "device_ms", "library_device_ms")


def kernel_row(name, numbers, counts):
    """One kernel's entry of the table: the numbers at the main shape of
    the first served path that runs it, launches summed over the serves
    (None when no serve ran), and each path's own numbers and launches
    under ``paths``."""
    paths = [arch for arch, names in PATH_KERNELS.items() if name in names]
    first = numbers.get(paths[0], dict.fromkeys(NUMBER_KEYS))
    return {"name": name, **KERNEL_META[name],
            "launches": sum(counts.values()) if counts else None, **first,
            "paths": {arch: {**numbers.get(arch, {}),
                             "launches": counts.get(arch)}
                      for arch in paths}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        fail(f"unknown phases {sorted(set(phases) - set(PHASES))}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an "
             "NVIDIA GPU")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    t_start = time.perf_counter()

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    log(f"build: {lib_path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s"
        + ("" if _build.BuildInfo.seconds is not None else " (already built)"))
    for line in _build.BuildInfo.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")) \
                or line.startswith("=="):
            log(f"  {line.strip()}")

    results = {}     # kernel -> served path -> numbers at its main shape
    launches = {}    # kernel -> served path -> launches in its serve
    if "kernels" in phases:
        run_kernels(torch, np.random.default_rng(args.seed), results)
    if "parity" in phases:
        for arch, window in PARITY_RUNS:
            run_parity(torch, np.random.default_rng(args.seed), args.seed,
                       arch, window)
    if "serve" in phases:
        for arch in PATH_KERNELS:
            counts = run_serve(torch, np.random.default_rng(args.seed),
                               args.seed, arch)
            for name, n in counts.items():
                launches.setdefault(name, {})[arch] = n
    log(f"total {time.perf_counter() - t_start:.1f} s")

    table = {"kernels": [
        kernel_row(name, results.get(name, {}), launches.get(name, {}))
        for name in KERNEL_META]}
    log(json.dumps(table))
    if set(phases) != set(PHASES):
        log(f"partial run ({','.join(phases)}): no result line")
        return
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
