#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
                          [--phases build,kernels,parity,serve,calibrate,
                                    experiments,train]

Phases, in order (all by default):

1. ``nvidia-smi``: the card's name and power limit.
2. ``build``: compile ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``
   into the git-ignored ``build/kernels/`` and load the library.
3. ``kernels``: each hand-written kernel against its plain PyTorch version
   on the card: the attention kernels in bf16 and f32, over ragged
   lengths, T and S that are not multiples of the tiles, GQA groups of 1,
   4, 5, 6, 10 and 16 (qwen2-vl-2b's 6, chatglm3-6b's 16 and llama4-scout's
   5 at their main shapes and off the tiles), head_dim 64, 128 and 256
   (recurrentgemma-2b's shapes, with windowed prefills past and off its
   tiles and a decode over a full ring), and llama4-scout's decode over an
   8192-row ring (1024 rows valid, ragged, on the split edges, all valid);
   the split-S decode also against its own algorithm in plain PyTorch
   (``decode_attention_split_plain``), at lengths 0, 1, on a split
   boundary and one either side of it, and with S off the split size;
   ``rwkv6_scan`` in f32 (o and final state) over ragged T (1, one
   either side of the kernel's 64-step chunk, up to ``max_seq_len``),
   B 8, D 64 and 128, a carried-in state, and fast decays against a
   step-by-step recurrence (there the plain chunked form overflows, at D
   64 and 128); ``rglru_scan`` in f32 over ragged T (the same lengths) and
   d (off the 4-channel vector too), a carried-in h0, strong decays and
   slow ones (where the carry between time chunks matters).
   Both scans are also called twice per case and must give the same bits
   (o and state).  Prints the error
   against the tolerance and the kernel's, the plain version's and (for
   attention) ``scaled_dot_product_attention``'s times beside the least
   time the card could take (``bound_ms``; f32 operations at 3xTF32 on the
   tensor cores, 165 TFLOP/s, the rate of the f32 attention kernels'
   products; the share is bound / device time).  ``ms``, ``plain_ms`` and
   ``library_ms`` are means of back-to-back calls, host launch overhead
   included where a call is shorter on the card than on the host;
   ``device_ms`` and ``library_device_ms`` time the same calls behind a
   GPU spin that fills the queue first, so they are device time alone,
   and give the achieved TFLOP/s (prefill) or GB/s (decode; also timed
   with the L2 cache flushed before each call).  ``flash_prefill`` in f32
   also at head_dim 80 (hubert-xlarge: bidirectional, and causal, on
   ragged T), and every f32 case's log-sum-exp output against the plain
   one (and at recurrentgemma-2b's training shape, T 4096 under its 2048
   window).  The backward kernel (``flash_prefill_bwd``: dQ, dK, dV)
   against autograd of the plain version on the card, at D 64 / 80 / 128 /
   256, G 1 / 4 / 10 / 16, causal / bidirectional / window, T off the
   tiles, at D 256 with its dK/dV launch split over 4 and 3 q-tile ranges
   and not split, and at the three training shapes, with the time of
   autograd's backward through ``scaled_dot_product_attention`` beside
   it.  The scans'
   backward kernels (``rwkv6_scan_bwd``, ``rglru_scan_bwd``) at their
   training shapes and off them, against autograd of the plain versions,
   and ``rwkv6_scan_bwd`` under fast decays and w under its clamp against
   autograd of the float64 step recurrence (dw exactly 0 under the
   clamp); each backward case called
   twice, the same bits; ``rwkv6_scan_bwd``'s four grid launches timed
   one by one under ``torch.profiler`` at its training shape.  Each wrapper of a kernel without a backward for
   its inputs (``decode_attention``; ``flash_prefill`` in bf16 or with a
   ``q_offset``; ``rwkv6_scan`` at D 128) must raise on a CUDA input that
   requires grad and launch nothing; f32 ``flash_prefill`` (D 64 / 80 /
   128 / 256), ``rwkv6_scan`` and ``rglru_scan`` inputs that require grad
   get a ``grad_fn`` whose backward launches the backward kernel.
4. ``parity``: llama3-8b, rwkv6-3b, qwen3-4b (qk_norm), chatglm3-6b (half
   rope) and qwen2-vl-2b (M-RoPE) at full width, 2 layers, and
   recurrentgemma-2b at full width, 3 layers (one RG-LRU, RG-LRU, local
   attention cycle), f32: one prompt and 8 greedy decode steps with the
   kernels on the card and with the plain versions on the CPU; logits
   within a stated tolerance, tokens equal.  A second recurrentgemma-2b
   run has its window reduced to 128 under a 190-token prompt, so that
   the prefill's ring is rolled and decode wraps it; a second qwen2-vl-2b
   run puts 64 vision patches through the frontend before its prompt.
   phi3.5-moe and llama4-scout run at full width and 1 layer (the host's
   free memory logged first), with each side's smallest top-k router
   margin and whether the chosen experts agree logged, then one
   ``moe_block`` on a decode-shaped input under
   ``torch.cuda.set_sync_debug_mode("error")``: no host sync allowed.
   Train parity: hubert-xlarge, llama3-8b and rwkv6-3b at full width, 2
   layers, and recurrentgemma-2b at full width, 3 layers, f32, one
   sequence of 256 frames / tokens: one training step (loss, gradients,
   AdamW) with the kernels on the card against the same step with the
   plain versions on the CPU, from the same weights: the loss, every
   gradient leaf and every parameter after the update within stated
   limits, the card's backward and update under
   ``set_sync_debug_mode("error")``, and each kernel's launches (per
   layer its forward kernel twice, its backward kernel once).
5. ``serve``: the main paths.  ``PaDGServer(backend="real")`` serves 16
   requests on two instances (``max_batch`` 8, ``max_seq_len`` 2048) of
   full-depth bf16 llama3-8b, then of rwkv6-3b, recurrentgemma-2b,
   qwen3-4b, chatglm3-6b and qwen2-vl-2b, then of full-width phi3.5-moe
   at 8 of its 32 layers and llama4-scout at 4 of its 48 (two whole
   instances do not fit the card; ``reduced`` is logged), on a wall
   clock; every request must finish with its token count, no logit row
   may hold a NaN or an infinity, and the launch counts of the path's
   kernels (all set to 0 just before each run, read just after it) must
   be > 0.  Then one
   ``EcoServeAPI.generate`` of 4 prompts, 8 new tokens each, on
   full-depth bf16 qwen3-4b: 8 tokens a prompt, 32 streamed, its kernels
   launched.
6. ``calibrate``: ``bench_calibration_torch.py``'s real backend on the
   card.  Two instances of full-width, full-depth bf16 llama3-8b serve the
   first 24 records of each checked-in trace excerpt (Azure, BurstGPT),
   each normalised to 4 req/s, prompts clipped to 1024 tokens and outputs
   to 1024 (the records' own but one): an unrecorded warm-up pass (outputs
   cut to 32), then the recorded pass on a wall clock with a
   ``CalibrationRecorder`` on each engine and a flight recorder
   (``repro_torch.obs.events.Tracer``) on the server and the recorder.
   The fitted
   ``CalibrationReport`` (samples, per-op error quantiles of the engines'
   seed model ``InstanceCostModel(cfg, hw=H100_SXM)`` and of the fit, the
   five constants, the fit's form and the decode steps by batch size and
   by context sum) is printed on one line, and the efficiencies the
   constants imply beside ``H100_SXM``'s on another.  Fails unless every
   request finishes with its token count, there is one prefill sample a
   request and some decode samples, every constant is finite and >= 0,
   the fit's median per-op error, overall and over the decode steps, is
   below the unfitted model's, and the recorded pass launched
   ``flash_prefill`` once a layer a prefill and ``decode_attention`` once
   a layer a decode step (counts set to 0 just before the recorded pass,
   read just after it).  Then it writes the report and the trace into the
   git-ignored ``build/calibration/`` (``report.json``, ``trace.jsonl``).
7. ``experiments`` (brings in ``calibrate``, so that it reads this run's
   files): the flight recorder's analyses and the simulator's experiment
   grid, fed by the calibrated serve.  ``python -m repro_torch.obs
   summarize`` on the trace must exit 0 (every request's TTFT attribution
   exact) with every request attributed; the attribution totals, the TPOT
   jitter and the interference score with its count are printed (a count
   of 0, which a wall clock gives, is printed as not measured), and
   ``python -m repro_torch.obs export --perfetto`` writes
   ``build/calibration/trace.perfetto.json``.  Then
   ``bench_calibration_torch.writeback_runner`` runs its 48 simulated
   cells (EcoServe, vLLM and Sarathi over both trace excerpts at 1, 2, 4
   and 8 req/s, each on the analytic cost model and on the card's fit):
   fails if a cell errs, finishes no request, or differs in seed from its
   twin; prints attainment and TPOT p50, analytic beside fitted.
8. ``train``: ``repro_torch.training.train_loop.train`` in f32 on
   hubert-xlarge at its full config (48 layers; frames from ``--seed`` at
   batch 8 x 1024, labels a fixed random linear classifier of the frames,
   5 steps) and on llama3-8b at full width with 4 of its 32 layers
   (``TokenDataset`` batches of ``synthetic_corpus``, 4 x 1024, 3 steps),
   on rwkv6-3b at its full config (32 layers, 4 x 1024 tokens, 3 steps)
   and on recurrentgemma-2b at its full config (26 layers, 1 x 4096
   tokens, so that its 2048 window bites, 3 steps), all with the
   reference's AdamW at lr ``TRAIN_LR`` (1e-4: the
   reference's ``train`` has no warmup, and at lr 3e-4 or 1e-3 both
   full-width models' losses climb back above their start within a few
   steps, as the reference's identical step would); each step's loss
   (finite, falling from the first to the last step), time, frames or
   tokens per second, peak device memory, the device-busy share of the
   last step under ``torch.profiler`` with its costliest kernels and the
   port's own, and each step's launches of the run's kernels (per layer
   its forward kernel twice, for the forward and its recomputation, and
   its backward kernel once).  Then ``python -m repro_torch.launch.train
   --arch <arch> --steps 3 --device cuda`` for llama3-8b and rwkv6-3b.

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
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("build", "kernels", "parity", "serve", "calibrate", "experiments",
          "train")

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, HBM3 rate.  f32
# work is counted at 3xTF32 on the tensor cores, 495 TFLOP/s / 3: the least
# time the card takes for a product that holds f32 accuracy (the attention
# kernels and rwkv6_scan's run their products so; the CUDA cores' 67 TFLOP/s
# of IEEE f32 is slower)
PEAK_OPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
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
# flash_prefill_bwd (f32) against autograd of the plain version: both sum
# the same products over up to T*G rows or S keys in another order (the
# kernel over its own tiles, 32-128 rows by 16-128 keys, with P recomputed
# from the log-sum-exp, dK/dV split over q-tile ranges where the card would
# not fill, every product in 3xTF32 on the tensor cores), so the error
# scales with each gradient's size: 1e-4 of its rms, and of |plain| (the
# CPU emulation of the kernel's algorithm, TF32 rounding included, holds
# it with a worst element near 0.05: tests/test_torch_attention_design.py)
TOL["grad"] = dict(atol=0.0, atol_rms=1e-4, rtol=1e-4)
# model parity, f32 logits: cuBLAS and the kernels sum 2560- to 14336-long
# products (and rwkv6_scan its T*D-term sums) in another order than the CPU
PARITY_ATOL = 1e-3
# the MoE paths
PHI, SCOUT = "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"


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
    # (an element equal on both sides uses none of its limit, even a zero
    # limit: a gradient that is zero on both sides)
    share = (float(torch.where(diff == 0, 0.0, diff / limit).max())
             if diff.numel() else 0.0)
    ok = bool(torch.isfinite(got).all()) and share <= 1.0
    return ok, max_abs, share


def tol_text(tol_name: str) -> str:
    t = TOL[tol_name]
    return (f"tol {t['atol']:g} + {t['atol_rms']:g}*rms + "
            f"{t['rtol']:.4g}*|plain|")


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #
# The first element names the served paths whose main shape the case is
# (its bf16 line goes into the kernel table under each), or is None.
FLASH_CASES = [  # paths, B, T, S, Hq, Hkv, D, causal, window, q_offset
    # llama3-8b's shape is qwen3-4b's and phi3.5-moe's too
    (("llama3-8b", "qwen3-4b", PHI), 1, 1024, 1024, 32, 8, 128, True, 0, 0),
    (None, 1, 1000, 1000, 32, 8, 128, True, 0, 0),  # T, S not tile multiples
    (None, 2, 200, 200, 10, 2, 128, True, 0, 0),    # G = 5
    (None, 2, 128, 128, 8, 2, 64, True, 0, 0),      # D = 64
    (None, 1, 64, 190, 4, 2, 64, True, 0, 126),     # chunked prefill offset
    (None, 1, 160, 160, 4, 2, 64, True, 32, 0),     # sliding window
    (None, 1, 128, 100, 4, 4, 64, False, 0, 0),     # bidirectional, S != T
    # recurrentgemma-2b's local attention: G = 10, D = 256, its 2048 window
    # (inactive below 2048 tokens), then a prefill past a 128 window
    (("recurrentgemma-2b",), 1, 1024, 1024, 10, 1, 256, True, 2048, 0),
    (None, 1, 1000, 1000, 10, 1, 256, True, 128, 0),
    # T and S off the bf16 kernel's 64-key tiles and its 64/G-position
    # q tiles; G = 1 (64 positions a tile, one left over); a
    # window that is no tile multiple and a chunked prefill past a window,
    # both at G = 10, D = 256
    (None, 1, 333, 333, 32, 8, 128, True, 0, 0),
    (None, 2, 65, 65, 4, 4, 64, True, 0, 0),
    (None, 1, 700, 700, 10, 1, 256, True, 100, 0),
    (None, 1, 100, 1100, 10, 1, 256, True, 300, 1000),
    # chatglm3-6b (G = 16: 4 positions a q tile) and qwen2-vl-2b (G = 6:
    # 10 positions and 4 dead rows a tile), then both off the tiles
    (("chatglm3-6b",), 1, 1024, 1024, 32, 2, 128, True, 0, 0),
    (("qwen2-vl-2b",), 1, 1024, 1024, 12, 2, 128, True, 0, 0),
    (None, 1, 333, 333, 32, 2, 128, True, 0, 0),
    (None, 1, 333, 333, 12, 2, 128, True, 0, 0),
    # llama4-scout: G = 5 (40 / 8; 12 positions and 4 dead rows a q tile)
    # at D 128, its 8192 window (inactive under 8192 tokens), then off the
    # tiles and past a window
    ((SCOUT,), 1, 1024, 1024, 40, 8, 128, True, 8192, 0),
    (None, 1, 333, 333, 40, 8, 128, True, 8192, 0),
    (None, 1, 1000, 1000, 40, 8, 128, True, 300, 0),
]
# f32 only: head_dim 80 (hubert-xlarge; bf16 has no D 80 kernel) and the
# training shapes, where the f32 numbers go into the table under the
# training paths
TRAIN_HUBERT, TRAIN_LLAMA = "train hubert-xlarge", "train llama3-8b"
TRAIN_RWKV, TRAIN_RG = "train rwkv6-3b", "train recurrentgemma-2b"
FLASH_F32_CASES = [
    ((TRAIN_HUBERT,), 8, 1024, 1024, 16, 16, 80, False, 0, 0),
    (None, 1, 333, 333, 16, 16, 80, True, 0, 0),
    (None, 2, 1000, 1000, 16, 16, 80, False, 0, 0),
    (None, 1, 100, 130, 16, 4, 80, False, 0, 0),    # S != T, G 4
    (None, 1, 500, 500, 8, 2, 80, True, 100, 0),    # window
    (None, 1, 81, 81, 64, 1, 80, True, 0, 0),       # G 64: 1 position a tile
    (None, 1, 200, 60, 4, 2, 64, True, 20, 0),      # rows with no key
    ((TRAIN_LLAMA,), 4, 1024, 1024, 32, 8, 128, True, 0, 0),
    # recurrentgemma-2b training: 4096 positions, so that the window bites
    ((TRAIN_RG,), 1, 4096, 4096, 10, 1, 256, True, 2048, 0),
]
DECODE_CASES = [  # paths, B, S, Hq, Hkv, D, lengths (a count or a kind)
    (("llama3-8b", "qwen3-4b", PHI), 8, 2048, 32, 8, 128, 1024),
    (None, 8, 2048, 32, 8, 128, "ragged"),
    (None, 4, 1000, 4, 4, 128, "ragged"),           # S not a tile multiple
    (None, 1, 512, 10, 2, 64, "ragged"),            # G = 5
    (None, 2, 256, 8, 2, 64, "ragged"),
    # recurrentgemma-2b: a W = 2048 ring half full, then full (every slot
    # valid, as after a wrap), then ragged
    (("recurrentgemma-2b",), 8, 2048, 10, 1, 256, 1024),
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
    # chatglm3-6b (G = 16, the kernel's MAX_GROUP: a full m16n8k16 head
    # tile) and qwen2-vl-2b (G = 6: 10 zero rows); Hkv 2 at B 8 takes more
    # splits a sequence than llama3-8b's Hkv 8
    (("chatglm3-6b",), 8, 2048, 32, 2, 128, 1024),
    (("qwen2-vl-2b",), 8, 2048, 12, 2, 128, 1024),
    (None, 8, 2048, 32, 2, 128, "ragged"),
    (None, 8, 2048, 12, 2, 128, "ragged"),
    (None, 6, 2048, 32, 2, 128, "edges"),
    (None, 6, 2048, 12, 2, 128, "edges"),
    (None, 4, 1000, 32, 2, 128, "tail"),
    (None, 4, 1000, 12, 2, 128, "tail"),
    (None, 4, 333, 32, 2, 128, "ragged"),
    (None, 4, 333, 12, 2, 128, "ragged"),
    # llama4-scout: G = 5 over its S = 8192 ring (local attention keeps
    # the whole window whatever max_seq_len is): 1024 valid rows, ragged,
    # the split edges, and every row valid (as after a wrap)
    ((SCOUT,), 8, 8192, 40, 8, 128, 1024),
    (None, 8, 8192, 40, 8, 128, "ragged"),
    (None, 6, 8192, 40, 8, 128, "edges"),
    (None, 8, 8192, 40, 8, 128, 8192),
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


def record(results, name, paths, **numbers):
    """Keep a kernel's numbers at the main shape of served ``paths``."""
    for path in paths or ():
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
        f32 = dtype == torch.float32
        for case in FLASH_CASES + (FLASH_F32_CASES if f32 else []):
            paths, B, T, S, Hq, Hkv, D, causal, window, off = case
            q = randn((B, T, Hq, D), dtype)
            k = randn((B, S, Hkv, D), dtype)
            v = randn((B, S, Hkv, D), dtype)
            kw = dict(causal=causal, window=window, q_offset=off)
            got = FP.flash_prefill(q, k, v, **kw)
            want = FP.flash_prefill_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            ok, err, share = compare(torch, got, want, dn)
            lse_text = ""
            if f32:     # the log-sum-exp the backward reads
                got2, lse = FP._forward_kernel(q, k, v, causal, window,
                                               off, True)
                _, want_lse = FP.flash_prefill_plain(q, k, v, **kw,
                                                     return_lse=True)
                torch.cuda.synchronize()
                empty = torch.isinf(want_lse)
                same_empty = torch.equal(empty, torch.isinf(lse)) and bool(
                    (lse[empty] < 0).all())
                ok_l, err_l, share_l = compare(
                    torch, lse.masked_fill(empty, 0.0),
                    want_lse.masked_fill(empty, 0.0), dn)
                ok = ok and ok_l and same_empty and torch.equal(got, got2)
                lse_text = (f"; lse max_abs_err={err_l:.3e} ({share_l:.3f} "
                            f"of its limit), {int(empty.sum())} empty rows "
                            f"-inf on both sides: {same_empty}")
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
                f"{share:.3f} of its limit{lse_text}) "
                f"{'ok' if ok else 'MISMATCH'} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"(device: kernel {dev_ms:.4f}, library {lib_dev_ms:.4f}) "
                f"bound_ms={b_ms:.4f} ({b_by}; share "
                f"{100 * b_ms / dev_ms:.0f}%) achieved on the device "
                f"{ops / dev_ms * 1e-9:.1f} TFLOP/s (SDPA "
                f"{ops / lib_dev_ms * 1e-9:.1f})")
            if dtype == torch.bfloat16 or case in FLASH_F32_CASES:
                record(results, "flash_prefill", paths, max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                       library_device_ms=lib_dev_ms)
        for case in DECODE_CASES:
            paths, B, S, Hq, Hkv, D, lens = case
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
                record(results, "decode_attention", paths, max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                       library_device_ms=lib_dev_ms)
    all_ok &= run_bwd_kernel(torch, rng, results)
    all_ok &= run_rwkv6_kernel(torch, rng, results)
    all_ok &= run_rglru_kernel(torch, rng, results)
    all_ok &= run_rwkv6_bwd_kernel(torch, rng, results)
    all_ok &= run_rglru_bwd_kernel(torch, rng, results)
    if not all_ok:
        fail("a kernel disagrees with its plain version (lines above)")
    check_grad_refused(torch)
    check_grad_carried(torch)


def check_grad_refused(torch):
    """Each wrapper of a kernel without a backward for these inputs raises
    on a CUDA input that requires grad while grad is enabled, launching
    nothing, and runs under ``torch.no_grad()``: ``decode_attention``,
    ``flash_prefill`` in bf16 and with a ``q_offset``, and ``rwkv6_scan``
    at head_dim 128 (its backward kernel takes 64)."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import rwkv6_scan as RS

    def t(*shape, dtype=torch.float32):
        return torch.rand(shape, device="cuda", dtype=dtype).requires_grad_()

    lengths = torch.tensor([3, 7], dtype=torch.int32, device="cuda")
    bf = torch.bfloat16
    calls = {
        "flash_prefill bf16": ("flash_prefill", lambda: FP.flash_prefill(
            t(1, 9, 4, 64, dtype=bf), t(1, 9, 2, 64, dtype=bf),
            t(1, 9, 2, 64, dtype=bf))),
        "flash_prefill f32 q_offset": ("flash_prefill",
                                       lambda: FP.flash_prefill(
                                           t(1, 9, 4, 64), t(1, 19, 2, 64),
                                           t(1, 19, 2, 64), q_offset=10)),
        "decode_attention": ("decode_attention", lambda: DA.decode_attention(
            t(2, 4, 64), t(2, 7, 2, 64), t(2, 7, 2, 64), lengths)),
        "rwkv6_scan D 128": ("rwkv6_scan", lambda: RS.rwkv6_scan(
            t(1, 5, 2, 128), t(1, 5, 2, 128), t(1, 5, 2, 128),
            t(1, 5, 2, 128), t(2, 128))),
    }
    wrappers = kernel_wrappers()
    for what, (name, call) in calls.items():
        before = wrappers[name].launches
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            fail(f"{what}: a CUDA input that requires grad did not raise")
        if wrappers[name].launches != before:
            fail(f"{what}: launched on an input that requires grad")
        with torch.no_grad():
            call()
        torch.cuda.synchronize()
        log(f"{what}: raises on a CUDA input that requires grad (no "
            "backward), runs under torch.no_grad(): ok")


def check_grad_carried(torch):
    """A CUDA input that requires grad trains through a backward kernel:
    ``flash_prefill`` (f32, D 64 / 80 / 128 / 256), ``rwkv6_scan`` (with
    s0 and a final-state cotangent) and ``rglru_scan`` (with h0) return a
    ``grad_fn`` (their autograd Functions), and backward launches the
    backward kernel once, with the gradients of autograd through the
    plain version."""
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import rglru_scan as RG
    from repro_torch.kernels import rwkv6_scan as RS

    wrappers = kernel_wrappers()

    def carried(what, fwd, bwd, call, leaves, cots, plain):
        n = (wrappers[fwd].launches, wrappers[bwd].launches)
        out = call(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        if outs[0].grad_fn is None:
            fail(f"{what}: no grad_fn")
        got = torch.autograd.grad(outs, leaves, cots)
        want = plain(*(x.detach() for x in leaves), *cots)
        torch.cuda.synchronize()
        shares = [compare(torch, g, w, "grad") for g, w in zip(got, want)]
        launched = (wrappers[fwd].launches - n[0],
                    wrappers[bwd].launches - n[1])
        if launched != (1, 1) or not all(ok for ok, _, _ in shares):
            fail(f"{what}: launches (forward, backward) {launched}, "
                 f"gradients {shares}")
        log(f"{what} on inputs that require grad: grad_fn "
            f"{type(outs[0].grad_fn).__name__}, launches forward 1, "
            f"backward 1; gradients at "
            + ", ".join(f"{sh:.3f}" for _, _, sh in shares)
            + f" of their limits ({tol_text('grad')}): ok")

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    for D, causal in ((64, True), (80, False), (128, True), (256, True)):
        q, k, v = (rn(*s).requires_grad_() for s in (
            (2, 77, 8, D), (2, 77, 2, D), (2, 77, 2, D)))
        carried(f"flash_prefill f32 D {D} causal={causal}", "flash_prefill",
                "flash_prefill_bwd",
                lambda q, k, v: FP.flash_prefill(q, k, v, causal=causal),
                (q, k, v), (rn(2, 77, 8, D),),
                lambda q, k, v, do: FP.flash_prefill_bwd_plain(
                    q, k, v, do, causal=causal))
    w = 0.6 + 0.39 * torch.rand((2, 77, 4, 64), generator=gen,
                                device="cuda")
    leaves = tuple(x.requires_grad_() for x in (
        rn(2, 77, 4, 64, scale=0.5), rn(2, 77, 4, 64, scale=0.5),
        rn(2, 77, 4, 64, scale=0.5), w, rn(4, 64, scale=0.1),
        rn(2, 4, 64, 64)))
    carried("rwkv6_scan D 64 with s0 and a final-state cotangent",
            "rwkv6_scan", "rwkv6_scan_bwd", RS.rwkv6_scan, leaves,
            (rn(2, 77, 4, 64), rn(2, 4, 64, 64)), RS.rwkv6_scan_bwd_plain)
    leaves = tuple(x.requires_grad_() for x in (
        -torch.rand((2, 77, 96), generator=gen, device="cuda") * 2.0,
        rn(2, 77, 96), rn(2, 96)))
    carried("rglru_scan with h0", "rglru_scan", "rglru_scan_bwd",
            RG.rglru_scan, leaves, (rn(2, 77, 96),), RG.rglru_scan_bwd_plain)


BWD_CASES = [  # paths, B, T, S, Hq, Hkv, D, causal, window
    ((TRAIN_HUBERT,), 8, 1024, 1024, 16, 16, 80, False, 0),
    ((TRAIN_LLAMA,), 4, 1024, 1024, 32, 8, 128, True, 0),
    (None, 2, 256, 256, 16, 16, 80, True, 0),       # T*G on the tiles
    (None, 1, 333, 333, 4, 4, 64, True, 0),         # G 1, ragged
    (None, 2, 200, 200, 16, 4, 64, False, 0),       # G 4, bidirectional
    (None, 1, 300, 300, 16, 1, 128, True, 0),       # G 16
    (None, 1, 500, 500, 8, 2, 80, True, 100),       # window, G 4
    (None, 2, 130, 130, 16, 16, 80, False, 0),      # ragged, hubert's heads
    (None, 1, 190, 190, 32, 2, 128, True, 64),      # G 16 under a window
    (None, 1, 100, 260, 4, 1, 64, False, 0),        # S != T, G 4
    (None, 1, 65, 65, 16, 1, 80, True, 0),          # G 16 at D 80
    (None, 1, 200, 60, 4, 2, 64, True, 20),         # rows with no key
    # head_dim 256 (two warps a 16-row or 16-key group, each over half of
    # D): recurrentgemma-2b's training shape, its window off the tiles,
    # bidirectional at G 2, rows with no key; the dK/dV launch split over
    # 4 q-tile ranges (all of these), over 3 (128 blocks), and not split
    # (320 blocks: two waves)
    ((TRAIN_RG,), 1, 4096, 4096, 10, 1, 256, True, 2048),
    (None, 1, 300, 300, 10, 1, 256, True, 100),
    (None, 1, 333, 333, 4, 2, 256, False, 0),
    (None, 1, 200, 60, 10, 1, 256, True, 20),
    (None, 1, 1024, 1024, 8, 8, 256, False, 0),
    (None, 2, 1024, 1024, 10, 10, 256, True, 0),
]


def run_bwd_kernel(torch, rng, results) -> bool:
    """``flash_prefill_bwd`` against autograd of the plain version on the
    card, and autograd's backward through ``scaled_dot_product_attention``
    (the forward's graph kept, the backward alone timed) as the library's
    time."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_prefill as FP

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape):
        x = rng.standard_normal(shape, "float32")
        return torch.from_numpy(x).to(dev)

    all_ok = True
    for case in BWD_CASES:
        paths, B, T, S, Hq, Hkv, D, causal, window = case
        q, do = randn((B, T, Hq, D)), randn((B, T, Hq, D))
        k, v = randn((B, S, Hkv, D)), randn((B, S, Hkv, D))
        kw = dict(causal=causal, window=window)
        o, lse = FP._forward_kernel(q, k, v, causal, window, 0, True)
        got = FP.flash_prefill_bwd(q, k, v, o, do, lse, **kw)
        got2 = FP.flash_prefill_bwd(q, k, v, o, do, lse, **kw)
        same = all(torch.equal(a, b) for a, b in zip(got, got2))
        want = FP.flash_prefill_bwd_plain(q, k, v, do, **kw)
        torch.cuda.synchronize()
        checks = [compare(torch, g, w, "grad") for g, w in zip(got, want)]
        ok = same and all(c[0] for c in checks)
        def kern():
            return FP.flash_prefill_bwd(q, k, v, o, do, lse, **kw)
        ms, dev_ms = cuda_ms(torch, kern), cuda_ms(torch, kern, spin=True)
        plain_ms = cuda_ms(torch, lambda: FP.flash_prefill_bwd_plain(
            q, k, v, do, **kw), iters=5, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        mask = (None if not window and (not causal or S == T)
                else sdpa_mask(torch, T, S, causal, window, 0, dev))
        out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=Hq != Hkv)
        dot = do.transpose(1, 2)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            out, (qt, kt, vt), dot, retain_graph=True)
        lib_ms, lib_dev_ms = (cuda_ms(torch, lib, iters=10),
                              cuda_ms(torch, lib, iters=10, spin=True))
        del out
        pairs = flash_pairs(T, S, causal, window, 0)
        ops = 10 * D * B * Hq * pairs
        nbytes = 4 * (4 * B * T * Hq * D + 4 * B * S * Hkv * D + B * Hq * T)
        b_ms, b_by = bound(nbytes, ops, "float32")
        err = max(c[1] for c in checks)
        all_ok &= ok
        log(f"flash_prefill_bwd float32 B={B} T={T} S={S} Hq={Hq} Hkv={Hkv} "
            f"D={D} causal={causal} window={window} (dK/dV over "
            f"{FP.bwd_split(B, Hkv, S, D, n_sm)} q-tile ranges): dq/dk/dv "
            f"max_abs_err "
            + "/".join(f"{c[1]:.3e}" for c in checks) + " (worst elements at "
            + "/".join(f"{c[2]:.3f}" for c in checks) + f" of their limits; "
            f"{tol_text('grad')}), two calls bit-identical: {same} "
            f"{'ok' if ok else 'MISMATCH'} kernel_ms={ms:.4f} (device "
            f"{dev_ms:.4f}) plain_ms={plain_ms:.4f} (autograd of the plain "
            f"forward, forward included) library_ms={lib_ms:.4f} (SDPA's "
            f"backward alone; device {lib_dev_ms:.4f}) bound_ms={b_ms:.4f} "
            f"({b_by}, 10 D operations a pair; share "
            f"{100 * b_ms / dev_ms:.0f}%) achieved on the device "
            f"{ops / dev_ms * 1e-9:.1f} TFLOP/s (SDPA "
            f"{ops / lib_dev_ms * 1e-9:.1f})")
        record(results, "flash_prefill_bwd", paths, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, device_ms=dev_ms,
               library_device_ms=lib_dev_ms)
        del qt, kt, vt
    return all_ok


RWKV_CASES = [  # B, T, H, D, carried-in state, decay
    (1, 1024, 40, 64, False, "slow"),           # rwkv6-3b prefill (main)
    (1, 1000, 40, 64, False, "slow"),           # T not a chunk multiple
    (1, 190, 40, 64, False, "slow"),            # a short ragged prompt
    (1, 1, 40, 64, False, "slow"),              # T = 1
    (1, 63, 40, 64, False, "slow"),             # one below the chunk
    (1, 65, 40, 64, False, "slow"),             # one above it
    (1, 2048, 40, 64, False, "slow"),           # max_seq_len
    (8, 256, 40, 64, True, "slow"),             # B = 8, s0 carried in
    (2, 300, 8, 64, True, "slow"),              # s0 carried in
    (1, 256, 8, 128, False, "slow"),            # D = 128
    (1, 190, 4, 64, True, "fast"),              # plain form overflows
    (1, 190, 4, 128, True, "fast"),             # the same at D = 128
    (4, 1024, 40, 64, False, "slow"),           # rwkv6-3b training
]
RWKV_TRAIN_CASE = RWKV_CASES[-1]


def rwkv6_ops(B, T, H, D) -> int:
    """f32 operations of the chunked WKV6 at the kernel's chunk on these T
    steps: per step and head 2 D^2 for the carried state's output and 2 D^2
    for the state update; per causal (t, s) pair of a chunk, s <= t, 2 D
    for the score and 2 D for A.V."""
    from repro_torch.kernels.rwkv6_scan import KERNEL_CHUNK as c
    full, rest = divmod(T, c)
    pairs = full * c * (c + 1) // 2 + rest * (rest + 1) // 2
    return B * H * (4 * D * D * T + 4 * D * pairs)


def rwkv6_form_bytes(B, T, H, D, carried) -> int:
    """Bytes the kernel's three passes move at these shapes, scratch
    included, each pass's reads and writes counted once: (a) k, w and v in
    (k and w once per 64-column block), deltas and decays out; (b) deltas,
    decays and s0 in, states entering each chunk and the final state out;
    (c) r, k, w (per column block), v, u and the entering states in, o
    out."""
    from repro_torch.kernels.rwkv6_scan import KERNEL_CHUNK
    n, blocks = -(-T // KERNEL_CHUNK), D // 64
    x, states, decays = B * T * H * D, B * H * n * D * D, B * H * n * D
    state = B * H * D * D
    floats = ((2 * blocks + 1) * x + states + decays
              + states + decays + (state if carried else 0) + states + state
              + (3 * blocks + 1) * x + H * D + states + x)
    return 4 * floats


def wkv6_steps(torch, r, k, v, w, u, s0):
    """The recurrence one step at a time (``repro.kernels.ref.rwkv6_ref``):
    an oracle that stays finite at any decay, in the inputs' dtype."""
    B, T, H, D = r.shape
    S = (torch.zeros((B, H, D, D), dtype=r.dtype, device=r.device)
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
        o2, st2 = RS.rwkv6_scan(r, k, v, w, u, s0)
        same = bool(torch.equal(o, o2) and torch.equal(st, st2))
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
        ok = ok_o and ok_s and same
        all_ok &= ok
        against = ("plain" if decay == "slow" else "step-by-step recurrence;"
                   f" plain chunked form finite: {plain_finite}")
        log(f"rwkv6_scan float32 B={B} T={T} H={H} D={D} s0={carried} "
            f"decay={decay} (against {against}): o max_abs_err={err_o:.3e}"
            f" (worst element at {share_o:.3f} of its limit), state "
            f"max_abs_err={err_s:.3e} ({share_s:.3f}) ({tol_text('rwkv6')})"
            f", two calls bit-identical: {same} {'ok' if ok else 'MISMATCH'}"
            f" kernel_ms={ms:.4f} (device {dev_ms:.4f}) plain_ms="
            f"{plain_ms:.4f} library_ms=null (no single PyTorch call "
            f"computes WKV6) bound_ms={b_ms:.4f} ({b_by}; the kernel's "
            f"passes move {rwkv6_form_bytes(B, T, H, D, carried) / 1e6:.1f}"
            f" MB)")
        if case is RWKV_CASES[0] or case is RWKV_TRAIN_CASE:
            record(results, "rwkv6_scan", ("rwkv6-3b",) if case is
                   RWKV_CASES[0] else (TRAIN_RWKV,),
                   max_abs_err=max(err_o, err_s), ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   device_ms=dev_ms, library_device_ms=None)
    return all_ok


RGLRU_CASES = [  # B, T, d, carried-in h0, decay
    (1, 1024, 2560, False, "model"),    # recurrentgemma-2b prefill (main)
    (1, 1000, 2560, False, "model"),    # T not a multiple of the chunk
    (1, 190, 2560, False, "model"),     # a short ragged prompt
    (1, 1, 2560, False, "model"),       # T = 1
    (1, 31, 2560, False, "model"),      # one below the kernel's time chunk
    (1, 33, 2560, False, "model"),      # one above it
    (1, 2048, 2560, False, "model"),    # max_seq_len
    (1, 256, 96, False, "model"),       # d not a multiple of a block's 256
    (1, 300, 98, True, "model"),        # d off the 4-channel vector
    (2, 300, 2560, True, "model"),      # h0 carried in
    (1, 190, 2560, True, "strong"),     # log_a near -10: h is almost b
    # tests/test_kernels.py's log_a = -|N(0,1)| / 10: a chunk keeps a
    # share of its carried h (in the model's range the product underflows)
    (1, 1024, 2560, False, "slow"),
    (2, 300, 2560, True, "slow"),
    (1, 4096, 2560, False, "model"),    # recurrentgemma-2b training
]
RGLRU_TRAIN_CASE = RGLRU_CASES[-1]


def rglru_form_bytes(B, T, d, carried) -> int:
    """Bytes the kernel's two passes move at these shapes, scratch
    included: pass 1 reads log_a and b of every chunk but the last and
    writes their aggregates; pass 2 reads h0, every chunk's predecessors'
    aggregates, log_a and b, and writes h."""
    from repro_torch.kernels.rglru_scan import time_chunk
    n = -(-T // time_chunk(T))
    before = min(T, (n - 1) * time_chunk(T))
    return 4 * B * d * (2 * before + 2 * (n - 1) + (1 if carried else 0)
                        + n * (n - 1) + 3 * T)


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
        elif decay == "slow":
            log_a = -np.abs(rng.standard_normal(shape)) * 0.1
        else:
            log_a = rng.uniform(-10.5, -9.5, shape)
        b = (np.sqrt(np.maximum(1.0 - np.exp(2.0 * log_a), 1e-12))
             * rng.standard_normal(shape))
        la, bb = arr(log_a), arr(b)
        h0 = arr(rng.standard_normal((B, d))) if carried else None
        got = RG.rglru_scan(la, bb, h0)
        same = bool(torch.equal(got, RG.rglru_scan(la, bb, h0)))
        want = RG.rglru_scan_plain(la, bb, h0)
        torch.cuda.synchronize()
        ok, err, share = compare(torch, got, want, "rglru")
        ok &= same
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
            f"worst element at {share:.3f} of its limit), two calls "
            f"bit-identical: {same} {'ok' if ok else 'MISMATCH'} kernel_ms="
            f"{ms:.4f} (device {dev_ms:.4f}) plain_ms={plain_ms:.4f} "
            f"library_ms=null (no single PyTorch call computes this scan) "
            f"bound_ms={b_ms:.4f} ({b_by}; the kernel's passes move "
            f"{rglru_form_bytes(B, T, d, carried) / 1e6:.1f} MB)")
        if case is RGLRU_CASES[0] or case is RGLRU_TRAIN_CASE:
            record(results, "rglru_scan", ("recurrentgemma-2b",) if case is
                   RGLRU_CASES[0] else (TRAIN_RG,),
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, device_ms=dev_ms,
                   library_device_ms=None)
    return all_ok


RWKV_BWD_CASES = [  # B, T, H, carried-in state, final-state cotangent, decay
    (4, 1024, 40, False, False, "slow"),   # rwkv6-3b training (main)
    (1, 1000, 40, False, False, "slow"),   # T not a chunk multiple
    (2, 130, 2, True, True, "slow"),       # s0 and dS_T, a ragged chunk
    (1, 1, 4, True, True, "slow"),         # T = 1
    # against the float64 step-by-step recurrence: fast decays (the plain
    # chunked form overflows) and 1% of w under the 1e-12 clamp
    (1, 190, 4, True, True, "fast"),
    (1, 300, 3, True, False, "clamp"),
]


def rwkv6_bwd_ops(B, T, H, D) -> int:
    """f32 operations of WKV6's gradient in the chunked form at the
    kernel's chunk: per step and head 2 D^2 each for the local state term,
    r's and k's state terms and v's; per causal (t, s) pair of a chunk 2 D
    each for the score, do . v, and the three intra-chunk sums."""
    from repro_torch.kernels.rwkv6_scan import KERNEL_CHUNK as c
    full, rest = divmod(T, c)
    pairs = full * c * (c + 1) // 2 + rest * (rest + 1) // 2
    return B * H * (8 * D * D * T + 10 * D * pairs)


def wkv6_step_grads(torch, r, k, v, w, u, s0, do, ds_final):
    """Autograd of ``wkv6_steps`` in float64 from w clamped at 1e-12, as
    the kernels clamp it: (dr, dk, dv, dw, du, ds0 or None), f32."""
    ins = [x.double().requires_grad_() for x in (r, k, v, w, u)]
    if s0 is not None:
        ins.append(s0.double().requires_grad_())
    o, S = wkv6_steps(torch, *ins[:3], torch.clamp(ins[3], min=1e-12),
                      ins[4], ins[5] if s0 is not None else None)
    outs, cots = [o], [do.double()]
    if ds_final is not None:
        outs.append(S)
        cots.append(ds_final.double())
    grads = [g.float() for g in torch.autograd.grad(outs, ins, cots)]
    return (*grads[:5], grads[5] if s0 is not None else None)


def launch_times(torch, fn, calls: int = 10):
    """[(kernel name, device ms a call)] of ``calls`` calls of ``fn`` under
    ``torch.profiler``, in the order the kernels first ran."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    first = {}
    for i, ev in enumerate(prof.events()):
        if ev.device_type.name == "CUDA":
            first.setdefault(ev.name, i)
    times = {ev.key: ev.device_time_total / 1e3 / calls
             for ev in prof.key_averages()
             if ev.device_type.name == "CUDA" and ev.device_time_total}
    return [(name.replace("(anonymous namespace)::", "").split("(")[0]
             .split("::")[-1], times[name])
            for name in sorted(times, key=lambda n: first.get(n, 0))]


def run_rwkv6_bwd_kernel(torch, rng, results) -> bool:
    """``rwkv6_scan_bwd`` (from the forward kernel's scratch) against
    autograd of the plain version, or of the float64 step recurrence where
    the plain chunked form overflows or w falls under its clamp."""
    from repro_torch.kernels import rwkv6_scan as RS

    dev = torch.device("cuda")

    def arr(x):
        return torch.from_numpy(x.astype("float32")).to(dev)

    all_ok = True
    for case in RWKV_BWD_CASES:
        B, T, H, carried, with_ds, decay = case
        D = 64
        shape = (B, T, H, D)
        r, k, v = (arr(rng.standard_normal(shape) * 0.5) for _ in range(3))
        lo, hi = (1e-3, 0.05) if decay == "fast" else (0.6, 0.999)
        wn = rng.uniform(lo, hi, shape)
        if decay == "clamp":
            wn[rng.random(shape) < 0.01] = 1e-14
        w = arr(wn)
        u = arr(rng.standard_normal((H, D)) * 0.1)
        s0 = arr(rng.standard_normal((B, H, D, D))) if carried else None
        do = arr(rng.standard_normal(shape))
        ds = arr(rng.standard_normal((B, H, D, D))) if with_ds else None
        _, _, scratch = RS._forward_kernel(r, k, v, w, u, s0)

        def kern():
            return RS.rwkv6_scan_bwd(r, k, v, w, u, s0, do, ds, s_in=scratch)
        got, got2 = kern(), kern()
        same = all(a is None or torch.equal(a, b) for a, b in zip(got, got2))
        clamped = True
        if decay == "slow":
            want = RS.rwkv6_scan_bwd_plain(r, k, v, w, u, s0, do, ds)
            against = "plain"
        else:
            p_got = RS.rwkv6_scan_bwd_plain(r, k, v, w, u, s0, do, ds)
            finite = all(bool(torch.isfinite(g).all())
                         for g in p_got if g is not None)
            want = wkv6_step_grads(torch, r, k, v, w, u, s0, do, ds)
            against = ("float64 step recurrence; plain chunked form's "
                       f"gradients finite: {finite}")
            if decay == "clamp":
                # no gradient passes the clamp: dw exactly 0 under it
                clamped = bool((got[3][w < 1e-12] == 0).all())
                against += f"; dw = 0 under the clamp: {clamped}"
        torch.cuda.synchronize()
        checks = [compare(torch, g, x, "grad") for g, x in zip(got, want)
                  if x is not None]
        ok = same and clamped and all(c[0] for c in checks)
        ms, dev_ms = cuda_ms(torch, kern), cuda_ms(torch, kern, spin=True)
        plain_ms = cuda_ms(torch, lambda: RS.rwkv6_scan_bwd_plain(
            r, k, v, w, u, s0, do, ds), iters=3, warmup=1)
        x = B * T * H * D
        state = B * H * D * D
        nbytes = 4 * (9 * x + 2 * H * D + (2 * state if carried else 0)
                      + (state if with_ds else 0))
        b_ms, b_by = bound(nbytes, rwkv6_bwd_ops(B, T, H, D), "float32")
        err = max(c[1] for c in checks)
        all_ok &= ok
        log(f"rwkv6_scan_bwd float32 B={B} T={T} H={H} D={D} s0={carried} "
            f"dS_T={with_ds} decay={decay} (against {against}): dr/dk/dv/"
            "dw/du" + ("/ds0" if carried else "") + " max_abs_err "
            + "/".join(f"{c[1]:.3e}" for c in checks) + " (worst elements "
            "at " + "/".join(f"{c[2]:.3f}" for c in checks) + " of their "
            f"limits; {tol_text('grad')}), two calls bit-identical: {same} "
            f"{'ok' if ok else 'MISMATCH'} kernel_ms={ms:.4f} (device "
            f"{dev_ms:.4f}) plain_ms={plain_ms:.4f} (autograd of the plain "
            "forward, forward included) library_ms=null (no single PyTorch "
            f"call computes WKV6's gradient) bound_ms={b_ms:.4f} ({b_by}; "
            f"share {100 * b_ms / dev_ms:.0f}%)")
        if case is RWKV_BWD_CASES[0]:
            log(f"rwkv6_scan_bwd B={B} T={T} H={H} D={D}: device ms a call "
                "by grid launch (torch.profiler, 10 calls): " + ", ".join(
                    f"{name} {t:.4f}" for name, t in launch_times(torch, kern)))
            record(results, "rwkv6_scan_bwd", (TRAIN_RWKV,), max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, device_ms=dev_ms, library_device_ms=None)
    return all_ok


RGLRU_BWD_CASES = [  # B, T, d, carried-in h0, decay
    (1, 4096, 2560, False, "model"),   # recurrentgemma-2b training (main)
    (1, 4096, 2560, True, "model"),    # the same with h0
    (2, 300, 2560, True, "model"),     # h0, T off the time chunk
    (1, 300, 98, True, "model"),       # d off the 4-channel vector
    (1, 1, 2560, True, "model"),       # T = 1
    (1, 1024, 2560, False, "slow"),    # a carry between chunks that matters
    (2, 300, 2560, True, "slow"),
]


def run_rglru_bwd_kernel(torch, rng, results) -> bool:
    """``rglru_scan_bwd`` (from the forward's h) against autograd of the
    plain version."""
    import numpy as np

    from repro_torch.kernels import rglru_scan as RG

    dev = torch.device("cuda")

    def arr(x):
        return torch.from_numpy(x.astype("float32")).to(dev)

    all_ok = True
    for case in RGLRU_BWD_CASES:
        B, T, d, carried, decay = case
        shape = (B, T, d)
        if decay == "model":            # as in RGLRU_CASES
            gate = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))
            log_a = -8.0 * np.log1p(np.e) * gate
        else:
            log_a = -np.abs(rng.standard_normal(shape)) * 0.1
        la, b = arr(log_a), arr(rng.standard_normal(shape))
        h0 = arr(rng.standard_normal((B, d))) if carried else None
        dy = arr(rng.standard_normal(shape))
        h = RG._forward_kernel(la, b, h0)

        def kern():
            return RG.rglru_scan_bwd(la, b, h0, h, dy)
        got, got2 = kern(), kern()
        same = all(a is None or torch.equal(a, c) for a, c in zip(got, got2))
        want = RG.rglru_scan_bwd_plain(la, b, h0, dy)
        torch.cuda.synchronize()
        checks = [compare(torch, g, x, "grad") for g, x in zip(got, want)
                  if x is not None]
        ok = same and all(c[0] for c in checks)
        ms, dev_ms = cuda_ms(torch, kern), cuda_ms(torch, kern, spin=True)
        plain_ms = cuda_ms(torch, lambda: RG.rglru_scan_bwd_plain(
            la, b, h0, dy), iters=2, warmup=1)
        # log_a, h, dy in, dlog_a and db out (h0 in, dh0 out); per element
        # an exp, a sum and three products
        nbytes = 4 * (5 * B * T * d + (2 * B * d if carried else 0))
        b_ms, b_by = bound(nbytes, 5 * B * T * d, "float32")
        err = max(c[1] for c in checks)
        all_ok &= ok
        log(f"rglru_scan_bwd float32 B={B} T={T} d={d} h0={carried} "
            f"decay={decay}: dlog_a/db" + ("/dh0" if carried else "")
            + " max_abs_err " + "/".join(f"{c[1]:.3e}" for c in checks)
            + " (worst elements at " + "/".join(f"{c[2]:.3f}" for c in checks)
            + f" of their limits; {tol_text('grad')}), two calls "
            f"bit-identical: {same} {'ok' if ok else 'MISMATCH'} kernel_ms="
            f"{ms:.4f} (device {dev_ms:.4f}) plain_ms={plain_ms:.4f} "
            "(autograd of the plain forward, forward included) "
            "library_ms=null (no single PyTorch call computes this scan's "
            f"gradient) bound_ms={b_ms:.4f} ({b_by}; share "
            f"{100 * b_ms / dev_ms:.0f}%)")
        if case is RGLRU_BWD_CASES[0]:
            record(results, "rglru_scan_bwd", (TRAIN_RG,), max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, device_ms=dev_ms, library_device_ms=None)
    return all_ok


# --------------------------------------------------------------------- #
# phase 4: model parity, kernels on the card vs plain versions on the CPU
# --------------------------------------------------------------------- #
def greedy(torch, params, cfg, prompt, n_new, device, patches=None):
    """One prompt (after ``patches``, (1, P, frontend_dim), if given) and
    ``n_new`` greedy decode steps: the tokens and each step's logits."""
    from repro_torch.models import forward, init_cache, write_slot

    toks = torch.tensor([prompt], dtype=torch.long, device=device)
    batch = {"tokens": toks}
    if patches is not None:
        batch["patches"] = patches.to(device)
    logits, pc = forward(params, cfg, batch, return_cache=True)
    T = logits.shape[1]             # the patches and the prompt
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
# flash_prefill's 6-position query tiles; chatglm3-6b's and qwen2-vl-2b's
# against flash_prefill's 4- and 10-position query tiles (G 16 and 6);
# llama4-scout's against its 12-position tiles (G 5)
PARITY_PROMPT = {"llama3-8b": 77, "rwkv6-3b": 190, "recurrentgemma-2b": 190,
                 "qwen3-4b": 77, "chatglm3-6b": 101, "qwen2-vl-2b": 77,
                 PHI: 77, SCOUT: 101}
# layers of the parity runs: 2, recurrentgemma-2b's one full (RG-LRU,
# RG-LRU, local attention) cycle, or 1 for the MoE models (llama4-scout's
# f32 weights are 16.6 GB a side at one layer, 8.1 GB of them the
# 202048-row embedding and head)
PARITY_LAYERS = {"recurrentgemma-2b": 3, PHI: 1, SCOUT: 1}
# (arch, reduced sliding window or None, vision patches before the prompt):
# the second recurrentgemma-2b run cuts the window to 128 under its
# 190-token prompt, so the prefill rolls the ring and decode wraps it on
# the card; the second qwen2-vl-2b run puts 64 patches (an 8 x 8 grid of
# M-RoPE positions) through the frontend before its prompt
PARITY_RUNS = [("llama3-8b", None, 0), ("rwkv6-3b", None, 0),
               ("recurrentgemma-2b", None, 0), ("recurrentgemma-2b", 128, 0),
               ("qwen3-4b", None, 0), ("chatglm3-6b", None, 0),
               ("qwen2-vl-2b", None, 0), ("qwen2-vl-2b", None, 64),
               (PHI, None, 0), (SCOUT, None, 0)]


def host_free_gb() -> float:
    import os
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 1e9


class RouteLog:
    """Wraps ``layers.moe_route`` while it is installed: each call's router
    logits and chosen experts, by the device they ran on."""

    def __init__(self, layers):
        self.layers, self.real = layers, layers.moe_route
        self.calls = {"cuda": [], "cpu": []}

    def __enter__(self):
        def logged(params, cfg, x):
            r = self.real(params, cfg, x)
            self.calls[x.device.type].append((r["logits"], r["experts"]))
            return r
        self.layers.moe_route = logged
        return self

    def __exit__(self, *exc):
        self.layers.moe_route = self.real

    def summary(self, torch, k: int) -> str:
        """Each side's smallest top-k margin (k-th minus (k+1)-th logit of
        a token), whether the chosen experts match call by call, and the
        largest router-logit difference."""
        def margins(side):
            out = [lg.sort(-1, descending=True).values.cpu()
                   for lg, _ in self.calls[side]]
            return torch.cat([v[:, k - 1] - v[:, k] for v in out])
        pairs = list(zip(self.calls["cuda"], self.calls["cpu"]))
        same = (len(self.calls["cuda"]) == len(self.calls["cpu"]) and all(
            torch.equal(ec.cpu(), eh) for (_, ec), (_, eh) in pairs))
        diff = max(float((lc.cpu() - lh).abs().max())
                   for (lc, _), (lh, _) in pairs)
        m_card, m_cpu = margins("cuda"), margins("cpu")
        return (f"{len(pairs)} routing calls a side, "
                f"{m_cpu.numel()} tokens; smallest top-{k} margin card "
                f"{float(m_card.min()):.3e}, cpu {float(m_cpu.min()):.3e} "
                f"({int((m_cpu < 1e-4).sum())} tokens under 1e-4); router "
                f"logits differ by at most {diff:.3e}; chosen experts equal "
                f"on both sides in every call: {same}")


def check_moe_no_sync(torch, params, cfg, seed):
    """``moe_block`` of layer 0 once on a decode-shaped input (B 8, T 1)
    under ``torch.cuda.set_sync_debug_mode("error")``: a device-to-host
    sync anywhere in it fails the phase (a decode step stays capturable by
    a CUDA graph)."""
    from repro_torch.models import layers as L

    ffn = params["layers"][0]["ffn"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((8, 1, cfg.d_model), generator=gen, device="cuda")
    want = L.moe_block(ffn, cfg, x)              # warm-up, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = L.moe_block(ffn, cfg, x)
    except RuntimeError as e:
        fail(f"{cfg.name}: moe_block synchronised with the host in a decode "
             f"step: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{cfg.name}: moe_block gave other bits on a second call")
    log(f"parity {cfg.name}: moe_block on (8, 1, {cfg.d_model}) (cap "
        f"{L.moe_capacity(cfg, 8)}) under set_sync_debug_mode('error'): no "
        "device-to-host sync, the same bits as its warm-up call")


def run_parity(torch, rng, seed, arch, window=None, n_patches=0):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    n_layers = PARITY_LAYERS.get(arch, 2)
    cfg = dataclasses.replace(get_config(arch), num_layers=n_layers)
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    if cfg.is_moe:
        log(f"parity {arch}: {host_free_gb():.1f} GB of host memory free "
            f"before {cfg.param_count() * 4 / 1e9:.1f} GB of f32 weights on "
            "each side")
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
    patches = (torch.from_numpy(rng.standard_normal(
        (1, n_patches, cfg.frontend_dim), "float32")) if n_patches else None)
    from repro_torch.models import layers
    with RouteLog(layers) as routes:
        t0 = time.perf_counter()
        tok_gpu, lg_gpu = greedy(torch, p_gpu, cfg, prompt, 8, "cuda",
                                 patches)
        t_gpu = time.perf_counter() - t0
        # the first torch.exp of a CPU process can come out less accurate
        # on part of its tensor (ROADMAP Queue 3): one call before the
        # reference
        torch.exp(torch.zeros(64))
        t0 = time.perf_counter()
        tok_cpu, lg_cpu = greedy(torch, p_cpu, cfg, prompt, 8, "cpu",
                                 patches)
        t_cpu = time.perf_counter() - t0
    err = float((lg_gpu - lg_cpu).abs().max())
    reduced = (f", window reduced to {window} (reduced run)" if window
               else "")
    if n_patches:
        reduced += f", {n_patches} vision patches before the prompt"
    log(f"parity {arch} width, {n_layers} layers{reduced}, f32, prompt {n} "
        f"+ 8 decode steps: max |logit diff| = {err:.3e} (tol "
        f"{PARITY_ATOL}), "
        f"logit range [{float(lg_cpu.min()):.2f}, {float(lg_cpu.max()):.2f}]"
        f"; tokens card {tok_gpu} cpu {tok_cpu}; card {t_gpu:.2f} s, "
        f"cpu {t_cpu:.2f} s (host clock)")
    if cfg.is_moe:
        log(f"parity {arch} routing: {routes.summary(torch, cfg.top_k)}")
    if not (torch.isfinite(lg_gpu).all() and err <= PARITY_ATOL):
        fail(f"{arch} parity: logits differ by {err:.3e} > {PARITY_ATOL}")
    if tok_gpu != tok_cpu:
        fail(f"{arch} parity: greedy tokens differ between card and CPU")
    if cfg.is_moe:
        check_moe_no_sync(torch, p_gpu, cfg, seed)
    del p_gpu, p_cpu
    torch.cuda.empty_cache()


# train parity: one training step, kernels on the card vs plain on the CPU;
# arch, layers, length (recurrentgemma-2b: one RG-LRU, RG-LRU, local
# attention cycle)
TRAIN_PARITY = (("hubert-xlarge", 2, 256), ("llama3-8b", 2, 256),
                ("rwkv6-3b", 2, 256), ("recurrentgemma-2b", 3, 256))
# the forward and backward kernel of each block kind
KIND_KERNELS = {"attn": ("flash_prefill", "flash_prefill_bwd"),
                "local": ("flash_prefill", "flash_prefill_bwd"),
                "rwkv6": ("rwkv6_scan", "rwkv6_scan_bwd"),
                "rglru": ("rglru_scan", "rglru_scan_bwd")}


def step_launches(cfg) -> dict:
    """Kernel launches of one training step: per layer its forward kernel
    twice (the forward and its recomputation under the block's checkpoint)
    and its backward kernel once."""
    from repro_torch.models.model import layer_kinds
    counts = {}
    for kind in layer_kinds(cfg):
        fwd, bwd = KIND_KERNELS[kind]
        counts[fwd] = counts.get(fwd, 0) + 2
        counts[bwd] = counts.get(bwd, 0) + 1
    return counts

# the loss: f32 sums in another order (cuBLAS and the kernels vs the CPU)
TRAIN_LOSS_RTOL = 1e-5
# each gradient leaf: |card - cpu| <= 1e-3 * rms(cpu leaf) + 1e-3 * |cpu|,
# a tenth of the forward's PARITY_ATOL on logits near 1, through the
# backward of two layers (the kernels' f32 limit is 2e-5 relative)
TOL["train_grad"] = dict(atol=0.0, atol_rms=1e-3, rtol=1e-3)


def adamw_limit(p_cpu, g_gpu, g_cpu, s_gpu, s_cpu, opt):
    """Per element, how far one AdamW step from zero moments may move the
    two sides' parameters apart given their gradients: the step is
    lr * (u + wd * p) with u = g/(|g| + eps) for the clipped gradient g
    (bias corrections cancel at step 1), and |u1 - u2| <= 2 |g1 - g2| /
    (|g1| + |g2| + eps); plus 1e-5 of lr and 2^-22 of |p| for f32 rounding
    of the update and the parameter."""
    a, b = g_gpu.double() * s_gpu, g_cpu.double() * s_cpu
    du = 2 * (a - b).abs() / (a.abs() + b.abs() + opt.eps)
    return opt.lr * (du + 1e-5) + p_cpu.double().abs() * 2.0 ** -22


def run_train_parity(torch, rng, seed, arch, layers, length):
    """One ``train_step``-equivalent at full width, ``layers`` layers, f32,
    batch 1 x ``length``: on the card (kernels) and on the CPU (plain
    versions) from the same weights; the card's backward and AdamW update
    under ``set_sync_debug_mode("error")``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_loss_fn
    from repro_torch.params import tree_leaves, tree_unflatten
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import loss_and_grads, to_batch

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p_gpu = init_params(cfg, gen, torch.float32, "cuda")
    p_cpu = tree_unflatten(p_gpu, iter(
        t.to("cpu", copy=True) for t in tree_leaves(p_gpu)))
    if cfg.modality == "audio":
        nb = {"frames": rng.standard_normal((1, length, cfg.frontend_dim),
                                            "float32")}
    else:
        nb = {"tokens": rng.integers(2, cfg.vocab_size - 1, (1, length))}
    nb["labels"] = rng.integers(0, cfg.vocab_size, (1, length))
    opt = AdamW()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0

    t0 = time.perf_counter()
    leaves = tree_leaves(p_gpu)
    for x in leaves:
        x.requires_grad_(True)
    loss_gpu = make_loss_fn(cfg)(p_gpu, to_batch(nb, torch.float32, "cuda"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = torch.autograd.grad(loss_gpu, leaves, allow_unused=True)
        g_gpu = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        state = opt.init(leaves)
        opt.update(g_gpu, state, leaves)
    except RuntimeError as e:
        fail(f"train parity {arch}: the backward or the update synchronised "
             f"with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in wrappers.items() if fn.launches}

    torch.exp(torch.zeros(64))      # (ROADMAP Queue 3: the CPU's first exp)
    t0 = time.perf_counter()
    loss_cpu, g_cpu = loss_and_grads(cfg, p_cpu, to_batch(nb, torch.float32,
                                                          "cpu"))
    g_cpu = tree_leaves(g_cpu)
    p_before = [x.detach().clone() for x in tree_leaves(p_cpu)]
    opt.update(g_cpu, opt.init(p_cpu), p_cpu)
    t_cpu = time.perf_counter() - t0

    def clip(gs):
        n = float(torch.sqrt(sum(g.double().square().sum() for g in gs)))
        return min(1.0, opt.grad_clip / (n + 1e-12)), n

    (s_gpu, n_gpu), (s_cpu, n_cpu) = clip(g_gpu), clip(g_cpu)
    lg, lc = float(loss_gpu.detach()), float(loss_cpu)
    ok = abs(lg - lc) <= TRAIN_LOSS_RTOL * abs(lc)
    g_share = p_share = 0.0
    for i, (gg, gc, pg, pc, p0) in enumerate(zip(
            g_gpu, g_cpu, leaves, tree_leaves(p_cpu), p_before)):
        gg = gg.cpu()
        ok_g, _, sh = compare(torch, gg, gc, "train_grad")
        g_share = max(g_share, sh)
        diff = (pg.detach().cpu().double() - pc.detach().double()).abs()
        lim = adamw_limit(p0, gg, gc, s_gpu, s_cpu, opt)
        sh_p = float((diff / lim).max()) if diff.numel() else 0.0
        p_share = max(p_share, sh_p)
        if not ok_g or sh_p > 1.0:
            log(f"train parity {arch}: leaf {i} {tuple(gc.shape)} gradient "
                f"at {sh:.3f} of its limit, parameter at {sh_p:.3f}")
            ok = False
    log(f"train parity {arch} full width, {layers} layers, f32, batch 1 x "
        f"{length}: "
        f"loss card {lg:.6f} cpu {lc:.6f} (rtol {TRAIN_LOSS_RTOL}); "
        f"gradients: {len(g_cpu)} leaves, worst element at {g_share:.3f} of "
        f"its limit ({tol_text('train_grad')}), global norm card {n_gpu:.6f}"
        f" cpu {n_cpu:.6f}; parameters after AdamW: worst element at "
        f"{p_share:.3f} of its limit (lr * (2|g1 - g2| / (|g1| + |g2| + "
        f"eps) + 1e-5) + 2^-22 |p|); backward and update under "
        f"set_sync_debug_mode('error'): no host sync; launches "
        f"{json.dumps(launches)}; card {t_gpu:.2f} s, cpu {t_cpu:.2f} s "
        "(host clock)")
    if not ok or not np.isfinite(lg):
        fail(f"train parity {arch}: card and CPU steps differ (lines above)")
    want = step_launches(cfg)
    if launches != want:
        fail(f"train parity {arch}: launches {launches}, expected {want} "
             "(per layer the forward kernel twice, for the forward and its "
             "recomputation, and the backward kernel once)")
    del p_gpu, g_gpu, leaves, state
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
                                      "decode_attention"),
                "qwen3-4b": ("flash_prefill", "decode_attention"),
                "chatglm3-6b": ("flash_prefill", "decode_attention"),
                "qwen2-vl-2b": ("flash_prefill", "decode_attention"),
                PHI: ("flash_prefill", "decode_attention"),
                SCOUT: ("flash_prefill", "decode_attention")}
# depth of the served MoE models: 2 instances of the whole models do not fit
# one 80 GB card (83.7 GB and 203.5 GB of bf16 weights each), so they serve
# at their published width with 8 of 32 and 4 of 48 layers (21.3 and 20.8 GB
# an instance; each model's one-block pattern is kept whole); the other
# paths serve at full depth
SERVE_LAYERS = {PHI: 8, SCOUT: 4}


def kernel_wrappers():
    """name -> the wrapper that carries the kernel's launch count."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_prefill import (flash_prefill,
                                                   flash_prefill_bwd)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd
    return {"flash_prefill": flash_prefill,
            "decode_attention": decode_attention,
            "rwkv6_scan": rwkv6_scan, "rglru_scan": rglru_scan,
            "flash_prefill_bwd": flash_prefill_bwd,
            "rwkv6_scan_bwd": rwkv6_scan_bwd,
            "rglru_scan_bwd": rglru_scan_bwd}


def run_serve(torch, rng, seed, arch):
    import numpy as np

    import repro_torch.serving.engine as engine_mod
    from repro_torch.configs import get_config
    from repro_torch.core.request import Request
    from repro_torch.core.slo import SLO
    from repro_torch.serving.padg_server import PaDGServer
    from repro_torch.serving.replay import WallClock

    cfg = get_config(arch)
    reduced = ""
    if arch in SERVE_LAYERS:
        reduced = (f" (reduced from {cfg.num_layers}: 2 instances of the "
                   "whole model do not fit the card)")
        cfg = dataclasses.replace(cfg, num_layers=SERVE_LAYERS[arch])
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
    log(f"serve {arch} bf16, {cfg.num_layers} layers{reduced}, "
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


API_ARCH = "qwen3-4b"
API_PROMPTS = ["the quick brown fox", "ecoserve rolls activation",
               "prefill then decode", "macro instances cooperate"]


def run_api(torch, seed, arch=API_ARCH):
    """One ``EcoServeAPI.generate`` at the arch's full width and depth in
    bf16: every prompt gets 8 tokens, all 32 are streamed, and the path's
    kernels launched (counts set to 0 just before the call)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.api import EcoServeAPI
    from repro_torch.serving.engine import EngineConfig

    cfg = get_config(arch)
    econf = EngineConfig(max_batch=8, max_seq_len=2048,
                         dtype=torch.bfloat16, eos_token=-1, device="cuda")
    wrappers = kernel_wrappers()
    gc.collect()
    torch.cuda.empty_cache()
    streamed = []
    with EcoServeAPI(cfg, n_instances=2, econf=econf, seed=seed) as api:
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = api.generate(API_PROMPTS, max_new_tokens=8,
                           stream=lambda i, tok: streamed.append((i, tok)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
    torch.cuda.empty_cache()
    log(f"api {arch} bf16, {cfg.num_layers} layers: EcoServeAPI.generate of "
        f"{len(API_PROMPTS)} prompts, max_new_tokens 8: {len(streamed)} "
        f"tokens streamed, wall_s={wall:.2f} (host clock) "
        f"launches={json.dumps(launches)}")
    for r in res:
        log(f"api {arch} {r.prompt!r}: tokens {r.tokens} ttft_s="
            f"{r.ttft_s:.3f}")
    if [r.prompt for r in res] != API_PROMPTS or any(
            len(r.tokens) != 8 or not all(0 <= t < cfg.vocab_size
                                          for t in r.tokens) for r in res):
        fail(f"api {arch}: not 8 tokens in the vocabulary for every prompt")
    if len(streamed) != 8 * len(API_PROMPTS):
        fail(f"api {arch}: {len(streamed)} tokens streamed, not "
             f"{8 * len(API_PROMPTS)}")
    for name in PATH_KERNELS[arch]:
        if launches[name] <= 0:
            fail(f"api {arch}: kernel {name} was never launched")


# --------------------------------------------------------------------- #
# phase 6: calibrate (the cost model's constants, fitted on the card)
# --------------------------------------------------------------------- #
CALIBRATE_PATH = "calibrate:llama3-8b"
CALIBRATE_KERNELS = {CALIBRATE_PATH: PATH_KERNELS["llama3-8b"]}
# the recorded pass's report and flight-recorder trace (git-ignored)
CALIBRATION_DIR = ROOT / "build" / "calibration"


def run_calibrate(torch, seed, smi):
    """The calibration loop on the card (``bench_calibration_torch``'s
    real backend); returns the recorded pass's launches."""
    import bench_calibration_torch as bench
    from repro_torch.obs.export import write_jsonl
    from repro_torch.serving.engine import H100_SXM

    wrappers = kernel_wrappers()

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    gc.collect()          # the serve phase's engines, cycles included
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = bench.serve_real("cuda", seed, before_recorded=zero_counts)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    report = run.report()
    cfg = bench.real_config("cuda")
    reqs, stats = run.requests, run.stats
    log(f"calibrate {bench.REAL_ARCH} {run.meta['dtype']}, {cfg.num_layers} "
        f"layers, {bench.REAL_INSTANCES} instances, max_batch "
        f"{bench.REAL_MAX_BATCH}, max_seq_len {bench.REAL_MAX_SEQ_LEN}: "
        f"{len(reqs)} requests of {'+'.join(bench.FIXTURES)} at "
        f"{bench.REAL_RATE:g} req/s each, prompts "
        f"{sum(r.prompt_len for r in reqs)} tokens, outputs "
        f"{sum(r.output_len for r in reqs)} tokens; warm-up and recorded "
        f"pass wall_s={wall:.2f} (host clock) peak_device_gb={peak_gb:.2f} "
        f"launches={json.dumps(launches)} ({smi})")
    log("calibrate report " + json.dumps({
        "n_prefill": report.n_prefill, "n_decode": report.n_decode,
        "unfitted": report.unfitted, "fitted": report.fitted,
        "constants": {k: report.constants[k] for k in (
            "prefill_base", "prefill_per_token", "decode_base",
            "decode_per_seq", "decode_per_ctx_token")},
        "fit": run.meta["fit"], "decode_spread": run.meta["decode_spread"],
        "finished": run.meta["finished"], "card": run.meta["card"]}))
    eff = bench.implied_efficiencies(report.constants, cfg, H100_SXM)
    log(f"calibrate implied efficiencies ({smi}): prefill_eff "
        f"{eff['prefill_eff']} (H100_SXM {H100_SXM.prefill_eff}), "
        f"decode_bw_eff {eff['decode_bw_eff']} (H100_SXM "
        f"{H100_SXM.decode_bw_eff}); decode_base as one read of the weights:"
        f" {eff['decode_base_bw_eff']} of HBM's rate")
    if len(stats.finished) != len(reqs) or stats.rejected:
        fail(f"calibrate: {len(stats.finished)} of {len(reqs)} finished")
    short = [r.rid for r in stats.finished
             if len(r.generated) != r.output_len]
    if short:
        fail(f"calibrate: requests {short} lack tokens")
    if report.n_prefill != len(reqs) or report.n_decode <= 0:
        fail(f"calibrate: {report.n_prefill} prefill and {report.n_decode} "
             f"decode samples for {len(reqs)} requests")
    if not bench.constants_ok(report.constants):
        fail(f"calibrate: fitted constants {report.constants}")
    for key in ("overall_median", "decode_median"):
        if not report.fitted[key] < report.unfitted[key]:
            fail(f"calibrate: the fit's {key} per-op error "
                 f"{report.fitted[key]} is not below the unfitted "
                 f"model's {report.unfitted[key]}")
    want = {"flash_prefill": cfg.num_layers * report.n_prefill,
            "decode_attention": cfg.num_layers * report.n_decode}
    for name in CALIBRATE_KERNELS[CALIBRATE_PATH]:
        if launches[name] <= 0 or launches[name] != want[name]:
            fail(f"calibrate: kernel {name} launched {launches[name]} times "
                 f"in the recorded pass, not {want[name]}")
    CALIBRATION_DIR.mkdir(parents=True, exist_ok=True)
    report.save(CALIBRATION_DIR / "report.json")
    n_events = write_jsonl(run.tracer, CALIBRATION_DIR / "trace.jsonl")
    log(f"calibrate wrote {(CALIBRATION_DIR / 'report.json').relative_to(ROOT)}"
        f" and {(CALIBRATION_DIR / 'trace.jsonl').relative_to(ROOT)} "
        f"({n_events} events)")
    return {name: launches[name] for name in CALIBRATE_KERNELS[CALIBRATE_PATH]}


# --------------------------------------------------------------------- #
# phase 7: experiments (the flight recorder and the simulator grid, fed by
# the calibrated serve)
# --------------------------------------------------------------------- #
def obs_cli(*args) -> subprocess.CompletedProcess:
    """``python -m repro_torch.obs <args>`` from this checkout."""
    return subprocess.run([sys.executable, "-m", "repro_torch.obs", *args],
                          cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
                          capture_output=True, text=True, timeout=300)


def run_experiments(seed, smi):
    """The calibrate phase's trace through ``python -m repro_torch.obs``,
    then its report through the write-back grid."""
    import bench_calibration_torch as bench
    from repro_torch.simulator.runner import ExperimentRunner

    trace = CALIBRATION_DIR / "trace.jsonl"
    report = CALIBRATION_DIR / "report.json"
    n_requests = len(bench.FIXTURES) * bench.REAL_PER_FIXTURE
    out = obs_cli("summarize", str(trace))
    if out.returncode != 0:
        fail(f"experiments: obs summarize exited {out.returncode} (an "
             f"inexact attribution exits 1): {out.stderr[-2000:]}")
    digest = json.loads(out.stdout)
    attr = digest["attribution"]
    if attr["n"] != n_requests or attr["unattributed"] != 0:
        fail(f"experiments: {attr['n']} of {n_requests} requests attributed,"
             f" {attr['unattributed']} unattributed")
    out = obs_cli("attribution", "--json", str(trace))
    if out.returncode != 0:
        fail(f"experiments: obs attribution exited {out.returncode}")
    tot = json.loads(out.stdout)["totals"]
    tpot, inter = digest["tpot"], digest["interference"]
    inter_text = (f"interference score {inter['score']} over n="
                  f"{inter['n']} stretches (p99 {inter['p99']})"
                  if inter["n"] else
                  "interference not measured on a wall clock (n=0: every "
                  "gap between two slots breaks the chain)")
    log(f"experiments trace: {digest['events']} events "
        f"{json.dumps(digest['by_type'])}; {attr['n']} attributed, "
        f"{attr['unattributed']} unattributed, exact {attr['exact']}; "
        f"totals s: queue_wait {tot['queue_wait']} prefill_wait "
        f"{tot['prefill_wait']} prefill_service {tot['prefill_service']} "
        f"transfer {tot['transfer']} ttft {tot['ttft']}; tpot over "
        f"{tpot['n']} requests: mean p50 {tpot['tpot_mean_p50']} jitter p50 "
        f"{tpot['tpot_jitter_p50']} p99 {tpot['tpot_jitter_p99']}; "
        f"{inter_text} ({smi})")
    perfetto = CALIBRATION_DIR / "trace.perfetto.json"
    out = obs_cli("export", str(trace), "--perfetto", "-o", str(perfetto))
    if out.returncode != 0:
        fail(f"experiments: obs export exited {out.returncode}")
    n_render = len(json.loads(perfetto.read_text())["traceEvents"])
    log(f"experiments perfetto: {perfetto.relative_to(ROOT)} "
        f"({n_render} trace events)")

    t0 = time.perf_counter()
    runner = bench.writeback_runner(report, seed=seed, n_workers=1)
    results = runner.run()
    wall = time.perf_counter() - t0
    cells = results["cells"]
    bad = [c for c in cells if "error" in c]
    if bad:
        fail(f"experiments: {len(bad)} write-back cells failed: "
             f"{bad[0]['error']}")
    empty = [(c["strategy"], c["scenario"], c["rate"], c["calibration"])
             for c in cells if not c["metrics"]["finished"] > 0]
    if empty:
        fail(f"experiments: write-back cells finished no request: {empty}")
    seeds = {}
    for c in cells:
        seeds.setdefault((c["strategy"], c["scenario"], c["rate"]),
                         set()).add(c["seed"])
    split = [k for k, v in seeds.items() if len(v) != 1]
    if split:
        fail(f"experiments: analytic and fitted twins differ in seed: {split}")
    grid = ExperimentRunner.grid(results)
    log(f"experiments write-back grid: {len(cells)} cells in {wall:.2f} s, "
        f"{runner.model} tp {runner.tp} x {runner.n_instances} instances, "
        f"{runner.workload} SLO, analytic = the runner's {runner.hw} roofline"
        " (its hardware table has no H100), fitted = this run's report")
    log(f"  {'strategy':9} {'scenario':15} {'rate':>5}  attainment "
        f"analytic/fitted  tpot_p50 s analytic/fitted")
    for strat in runner.strategies:
        for scen in runner.scenarios:
            node = grid[strat][scen]
            for rate in runner.rates:
                a, f = node["analytic"][rate], node[str(report)][rate]
                log(f"  {strat:9} {scen:15} {rate:5g}  {a['attainment']:.4f} / "
                    f"{f['attainment']:.4f}  {a['tpot_p50']:.6f} / "
                    f"{f['tpot_p50']:.6f}")


# --------------------------------------------------------------------- #
# phase 7: train (the training path)
# --------------------------------------------------------------------- #
# run name -> (arch, layers or None for the full depth, batch, length,
# steps); each run's kernels are TRAIN_KERNELS'
# (recurrentgemma-2b at 4096 positions, so that its 2048 window bites)
TRAIN_RUNS = {TRAIN_HUBERT: ("hubert-xlarge", None, 8, 1024, 5),
              TRAIN_LLAMA: ("llama3-8b", 4, 4, 1024, 3),
              TRAIN_RWKV: ("rwkv6-3b", None, 4, 1024, 3),
              TRAIN_RG: ("recurrentgemma-2b", None, 1, 4096, 3)}
TRAIN_KERNELS = {TRAIN_HUBERT: ("flash_prefill", "flash_prefill_bwd"),
                 TRAIN_LLAMA: ("flash_prefill", "flash_prefill_bwd"),
                 TRAIN_RWKV: ("rwkv6_scan", "rwkv6_scan_bwd"),
                 TRAIN_RG: ("rglru_scan", "rglru_scan_bwd", "flash_prefill",
                            "flash_prefill_bwd")}
# AdamW's lr in the training runs.  ``train`` (like the reference's) has no
# warmup: at 3e-4 and 1e-3 the first update lowers the loss and the next
# ones overshoot, until hubert-xlarge (48 layers) and llama3-8b end above
# their first step's loss (PERF.md, PR 18); at 1e-4 both end below it
TRAIN_LR = 1e-4


class StepClock:
    """The batch iterator of a ``train`` run, instrumented: ``train`` asks
    for step i's batch after step i - 1's loss reached the host, so the
    time between two requests (after a device synchronise) is a step, and
    the kernels' launch counts are read and set to 0 there.  The last step
    runs under ``torch.profiler`` (started at its request; the caller
    stops it after ``train`` returns)."""

    def __init__(self, torch, batches, steps):
        self.torch, self.batches, self.steps = torch, iter(batches), steps
        self.wrappers = kernel_wrappers()
        self.marks, self.launches, self.prof = [], [], None

    def _mark(self):
        self.torch.cuda.synchronize()
        now = time.perf_counter()
        if self.marks:
            self.launches.append({n: fn.launches
                                  for n, fn in self.wrappers.items()})
        for fn in self.wrappers.values():
            fn.launches = 0
        self.marks.append(now)

    def __iter__(self):
        return self

    def __next__(self):
        self._mark()
        if len(self.marks) == self.steps:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
        return next(self.batches)

    def finish(self):
        """End of the last step (``train`` returned): stop the profiler;
        (step seconds, launches per step, [(kernel, device ms)] of the
        last step, costliest first)."""
        self._mark()
        self.prof.stop()
        kernels = sorted(((ev.key, ev.device_time_total / 1e3)
                          for ev in self.prof.key_averages()
                          if ev.device_type.name == "CUDA"),
                         key=lambda r: -r[1])
        steps = [b - a for a, b in zip(self.marks, self.marks[1:])]
        return steps, self.launches, kernels


def hubert_batches(rng, cfg, B, T, steps):
    """Frames (B, T, frontend_dim) from the seed, new every step, with
    cluster-like targets as HuBERT's k-means labels are: a frame's label is
    its class under one fixed random linear classifier whose classes have
    a skewed prior (class c's score lowered by 8 log(1 + c)), so class
    frequencies fall off as cluster sizes do.  (With a flat prior the
    classes are about equally frequent, the model at init already predicts
    them about uniformly, and 5 steps from random init did not lower the
    loss: PERF.md, PR 18.)"""
    import numpy as np

    w = rng.standard_normal((cfg.frontend_dim, cfg.vocab_size), "float32")
    prior = -8.0 * np.log1p(np.arange(cfg.vocab_size, dtype=np.float32))
    out = []
    for _ in range(steps):
        frames = rng.standard_normal((B, T, cfg.frontend_dim), "float32")
        out.append({"frames": frames,
                    "labels": (frames @ w + prior).argmax(-1)})
    return out


def run_train(torch, rng, seed, name, smi):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (ByteTokenizer, TokenDataset,
                                           synthetic_corpus)
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import train

    arch, layers, B, T, steps = TRAIN_RUNS[name]
    cfg = get_config(arch)
    reduced = ""
    if layers:
        reduced = f" (reduced from {cfg.num_layers})"
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.modality == "audio":
        batches, unit = hubert_batches(rng, cfg, B, T, steps), "frames"
    else:
        ds = TokenDataset.from_texts(synthetic_corpus(512),
                                     ByteTokenizer(cfg.vocab_size))
        batches, unit = ds.batches(B, T, seed=seed), "tokens"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    clock = StepClock(torch, batches, steps)
    t0 = time.perf_counter()
    opt = AdamW(lr=TRAIN_LR)
    _, losses = train(cfg, clock, steps=steps, optimizer=opt, seed=seed,
                      log_every=1, log_fn=lambda m: log(f"train {arch}: {m}"),
                      device="cuda")
    wall = time.perf_counter() - t0
    secs, launches, kernels = clock.finish()
    busy = sum(t for _, t in kernels)

    def short(k):
        return k.replace("void ", "").replace("(anonymous namespace)::",
                                              "").split("(")[0][:60]
    top = ", ".join(f"{short(k)} {t:.1f}" for k, t in kernels[:6])
    own = ", ".join(f"{short(k)} {t:.1f}" for k, t in kernels
                    if "repro_torch::" in k)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    timed = secs[1:-1] or secs[-1:]       # after step 0, unprofiled
    step_s = float(np.median(timed))
    share, share_last = busy / 1e3 / step_s, busy / 1e3 / secs[-1]
    per_step = {n: sorted({c[n] for c in launches})
                for n in TRAIN_KERNELS[name]}
    log(f"train {arch} f32, {cfg.num_layers} layers{reduced}, "
        f"{cfg.param_count() / 1e9:.3f}B parameters, batch {B} x {T} "
        f"{unit}, {steps} steps, AdamW(lr={opt.lr:g}) [{smi}]: losses "
        f"{[round(x, 5) for x in losses]}; step s "
        f"{[round(x, 3) for x in secs]} (host clock, after a device "
        f"synchronise); median after step 0 (unprofiled) {step_s:.3f} s, "
        f"{B * T / step_s:.0f} {unit}/s; peak device memory {peak_gb:.2f} "
        f"GB; the last step under the profiler: {secs[-1]:.3f} s, device "
        f"busy {busy:.1f} ms ({100 * share:.0f}% of the median step, "
        f"{100 * share_last:.0f}% of the profiled one); launches per step "
        f"{json.dumps(per_step)}; wall {wall:.1f} s")
    log(f"train {arch} profiled step, device ms by kernel: {top}; the "
        f"port's kernels: {own}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train {arch}: losses {losses} not finite and falling")
    want = {n: [c] for n, c in step_launches(cfg).items()}
    if per_step != want:
        fail(f"train {arch}: launches per step {per_step}, expected {want}")
    return {n: sum(c[n] for c in launches) for n in TRAIN_KERNELS[name]}


TRAIN_CLI_ARCHS = ("llama3-8b", "rwkv6-3b")


def run_train_cli(torch):
    """The launcher's own check: ``python -m repro_torch.launch.train
    --arch <arch> --steps 3 --device cuda`` (its smoke config) for each of
    ``TRAIN_CLI_ARCHS``."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for arch in TRAIN_CLI_ARCHS:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             arch, "--steps", "3", "--device", "cuda"], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=600)
        for line in out.stdout.strip().splitlines():
            log(f"train cli {arch}: {line}")
        if out.returncode != 0 or "(improved)" not in out.stdout:
            fail(f"python -m repro_torch.launch.train --arch {arch} failed "
                 f"(exit {out.returncode}): {out.stderr[-2000:]}")
        log(f"train cli {arch}: exit 0 in {time.perf_counter() - t0:.1f} s")


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
    # the gradient of the forward's function (JAX differentiates
    # blockwise_attention; no TPU kernel has a backward)
    "flash_prefill_bwd": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_prefill_bwd.cu",
        replaces="src/repro/kernels/flash_prefill.py:82"),
    # the scans' gradients (JAX differentiates rwkv6_chunked_jnp and
    # rglru_scan_jnp)
    "rwkv6_scan_bwd": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:71"),
    "rglru_scan_bwd": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:47"),
}
NUMBER_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "device_ms", "library_device_ms")


def kernel_row(name, numbers, counts):
    """One kernel's entry of the table: the numbers at the main shape of
    the first served path that runs it, launches summed over the runs
    (None when no serve ran), and each path's own numbers and launches
    under ``paths``."""
    paths = [arch for arch, names in {**PATH_KERNELS, **CALIBRATE_KERNELS,
                                      **TRAIN_KERNELS}.items()
             if name in names]
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
    if "experiments" in phases and "calibrate" not in phases:
        phases.append("calibrate")     # it reads this run's files only

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
        for arch, window, n_patches in PARITY_RUNS:
            run_parity(torch, np.random.default_rng(args.seed), args.seed,
                       arch, window, n_patches)
        for arch, layers, length in TRAIN_PARITY:
            run_train_parity(torch, np.random.default_rng(args.seed),
                             args.seed, arch, layers, length)
    if "serve" in phases:
        for arch in PATH_KERNELS:
            counts = run_serve(torch, np.random.default_rng(args.seed),
                               args.seed, arch)
            for name, n in counts.items():
                launches.setdefault(name, {})[arch] = n
        run_api(torch, args.seed)
    if "calibrate" in phases:
        for name, n in run_calibrate(torch, args.seed, smi).items():
            launches.setdefault(name, {})[CALIBRATE_PATH] = n
    if "experiments" in phases:
        run_experiments(args.seed, smi)
    if "train" in phases:
        for name in TRAIN_RUNS:
            counts = run_train(torch, np.random.default_rng(args.seed),
                               args.seed, name, smi)
            for kname, n in counts.items():
                launches.setdefault(kname, {})[name] = n
        run_train_cli(torch)
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
