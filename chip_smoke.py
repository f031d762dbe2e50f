#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
                          [--phases build,kernels,parity,serve,calibrate,
                                    experiments,train,mesh]

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
   the paper's models: G 8 (qwen2-72b, codellama2-34b) and 52 MHA heads
   (llama-30b) at LongBench's 4096-token clip and off the tiles, decode
   over their 8192-row caches with 2048-4096 rows valid; the 32k paths'
   shapes: ``flash_prefill`` at T = S = 32768, causal and under an 8192
   window, against its plain version run 512 query rows at a time, and
   ``decode_attention`` over 8 x 32768 valid rows and llama3-8b-sw's full
   8192-row ring; the long_500k paths' shapes: ``flash_prefill`` at T = S
   = 524288 under llama4-scout's 8192 window and recurrentgemma-2b's 2048
   (q 2.7e9 elements at llama4-scout's) against the f32 attention run 512
   query rows at a time, ``decode_attention`` at batch 1 over their full
   rings, ``rwkv6_scan`` over (1, 524288, 40, 64) with its final state
   and ``rglru_scan`` over (1, 524288, 2560) against their chunked plain
   versions, inputs drawn on the card; the split-S decode also against
   its own algorithm in plain PyTorch (``decode_attention_split_plain``),
   at lengths 0, 1, on a split boundary and one either side of it, and
   with S off the split size;
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
   ragged T), and every case's log-sum-exp output (f32 in both dtypes)
   against the plain one, with the kernel's device time with and without
   it; at the training shapes too (recurrentgemma-2b's T 4096 under its
   2048 window; in bf16 llama3-8b's and recurrentgemma-2b's).  The
   backward kernel (``flash_prefill_bwd``: dQ, dK, dV) against autograd
   of the plain version on the card, in f32 at D 64 / 80 / 128 / 256, G 1
   / 4 / 10 / 16, causal / bidirectional / window, T off the tiles, at D
   256 with its dK/dV launch split over 4 and 3 q-tile ranges and not
   split, at the three training shapes and qwen2-vl-2b's (G 6, for its
   f32-promoted patch path), and in bf16 (each element at
   ``TOL["grad_bf16"]``, each gradient within ``GRAD_BF16_REL_L2``
   relative L2) at the bf16 training shapes: llama3-8b's (also qwen3-4b's
   and phi3.5-moe's), recurrentgemma-2b's, chatglm3-6b's (G 16 on 2 kv
   heads, its dK/dV launch split over 4 ranges at D 128), qwen2-vl-2b's
   (G 6) and llama4-scout's G 5 under its 8192 window at T 16384 (held
   to the f32 gradient of the same inputs, see ``BWD_LONG_T``), then D 64
   ragged and
   bidirectional, G 16 under a window, rows with no key and D 256 split
   over 3 ranges, with the time of autograd's backward through
   ``scaled_dot_product_attention`` beside it.  The scans'
   backward kernels (``rwkv6_scan_bwd``, ``rglru_scan_bwd``) at their
   training shapes and off them, against autograd of the plain versions,
   and ``rwkv6_scan_bwd`` under fast decays and w under its clamp against
   autograd of the float64 step recurrence (dw exactly 0 under the
   clamp); each backward case called
   twice, the same bits; ``rwkv6_scan_bwd``'s four grid launches timed
   one by one under ``torch.profiler`` at its training shape.  Each
   wrapper of a kernel without a backward for its inputs
   (``decode_attention``; ``flash_prefill`` with a ``q_offset``, f32 and
   bf16; ``rwkv6_scan`` at D 128) must raise on a CUDA input that
   requires grad and launch nothing (bf16 ``flash_prefill`` at D 80 has
   no kernel and raises either way); ``flash_prefill`` (f32 at D 64 / 80
   / 128 / 256, bf16 at D 128), ``rwkv6_scan`` and ``rglru_scan`` inputs
   that require grad get a ``grad_fn`` whose backward launches the
   backward kernel.
4. ``parity``: first ``apply_rope`` of the long_500k archs on the card at
   positions 524160-524351 against the CPU (``ROPE_ATOL``), then
   llama3-8b, llama3-8b-sw, rwkv6-3b, qwen3-4b (qk_norm), chatglm3-6b (half
   rope) and qwen2-vl-2b (M-RoPE) at full width, 2 layers, and
   recurrentgemma-2b at full width, 3 layers (one RG-LRU, RG-LRU, local
   attention cycle), f32: one prompt and 8 greedy decode steps with the
   kernels on the card and with the plain versions on the CPU; logits
   within a stated tolerance, tokens equal.  A second recurrentgemma-2b
   run has its window reduced to 128 under a 190-token prompt, so that
   the prefill's ring is rolled and decode wraps it; a second qwen2-vl-2b
   run puts 64 vision patches through the frontend before its prompt.
   phi3.5-moe and llama4-scout run at full width and 1 layer (the host's
   free memory logged first, as for the paper's llama-30b, codellama2-34b
   and qwen2-72b at full width, 2 layers, 101-token prompts after them),
   with each side's smallest top-k router
   margin and whether the chosen experts agree logged, then one
   ``moe_block`` on a decode-shaped input under
   ``torch.cuda.set_sync_debug_mode("error")``: no host sync allowed.
   The long_500k archs (rwkv6-3b, recurrentgemma-2b, llama3-8b-sw,
   llama4-scout) also take one decode step at batch 1 and ``cache_len``
   524287 from a cache drawn from the seed, logits and every cache tensor
   within ``PARITY_ATOL``.  Each row's CPU side runs on a host thread
   (one row's at a time) while the card side of the next dense row runs.
   Train parity: hubert-xlarge, rwkv6-3b, qwen3-4b, chatglm3-6b and
   qwen2-vl-2b at full width, 2 layers, llama3-8b at 1 and
   recurrentgemma-2b at 3, f32, then llama3-8b, recurrentgemma-2b, qwen3-4b,
   chatglm3-6b and qwen2-vl-2b again in bf16 (through the bf16 backward
   kernel), and qwen2-vl-2b's bf16 weights with 64 f32 vision patches
   before its tokens (computing in f32, through the f32 kernels), then
   phi3.5-moe and llama4-scout at full width, 1 layer, f32 (the host's
   free memory logged first; their routing logged on both sides, the
   chosen experts equal in every call of the forward and the
   recomputation), one sequence of 256 frames / tokens: one training
   step (loss, gradients, AdamW) with the kernels on the card against the
   same step with the plain versions on the CPU, from the same weights:
   the loss, every gradient leaf (in bf16 by its relative L2 difference)
   and every parameter after the update within stated limits (compared
   on the card leaf by leaf), the card's backward and update (the MoE
   backward's capacity cumsum and scatters included) under
   ``set_sync_debug_mode("error")``, and each kernel's launches (per
   layer its forward kernel twice, its backward kernel once).
5. ``serve``: the main paths.  ``PaDGServer(backend="real")`` serves 16
   requests on two instances (``max_batch`` 8, ``max_seq_len`` 2048) of
   bf16 llama3-8b, then of rwkv6-3b, recurrentgemma-2b, qwen3-4b,
   chatglm3-6b, qwen2-vl-2b and qwen1.5-32b, all at full width and 8
   layers (9 for
   recurrentgemma-2b's 3-block pattern; full-depth llama3-8b and
   qwen3-4b serve in phases 6 and 5's API check), then of full-width
   phi3.5-moe at 2 of its 32 layers and llama4-scout at 2 of its 48 (two
   whole instances do not fit the card; ``reduced`` is logged), then the
   paper's models at 4 layers under their Table-4 traffic
   (``simulator/workload.WORKLOADS``, ``max_seq_len`` 8192): llama-30b
   under ShareGPT, codellama2-34b under LongBench, qwen2-72b under Alpaca,
   on a wall clock; every request must finish with its token count, no
   logit row may hold a NaN or an infinity, and the launch counts of the
   path's kernels (all set to 0 just before each run, read just after it)
   must be > 0.  Then one ``EcoServeAPI.generate`` of 4 prompts, 8 new
   tokens each, on full-depth bf16 qwen3-4b: 8 tokens a prompt, 32
   streamed, its kernels launched.  Then ``ENGINE_PATHS`` through one
   ``ServingEngine`` each, at full depth, held to the same rules: the
   whole 48-layer codellama2-34b on one 4096-token prompt (32 tokens),
   32k-token contexts (llama3-8b whole and llama3-8b-sw at 8 layers,
   prompts of 32704 and 16411 tokens, 64 tokens each, ``max_seq_len``
   32832), and the reference's long_500k: one 524288-token prompt and 16
   tokens at ``max_batch`` 1 on rwkv6-3b, recurrentgemma-2b and
   llama3-8b-sw whole and llama4-scout at 2 layers, each path's peak
   device memory beside its prefill's, reckoned from shapes
   (``reckon_prefill_gb``); qwen2-72b's whole instance is logged as not
   fitting.
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
   its backward kernel once).  Then the same four runs in bf16
   (``train(dtype=torch.bfloat16)``) at the same shapes: the same
   printout, the losses finite, the first within
   ``TRAIN_BF16_FIRST_LOSS_RTOL`` of its f32 twin's, and whether the loss
   falls (printed; the reference rounds each update into bf16 parameters
   as the port does); hubert-xlarge keeps bf16 weights and computes in
   f32 from its f32 frames on, as the reference promotes them.  Then the
   five decoders that train in bf16 only, at full width: qwen3-4b and
   chatglm3-6b at 8 layers, qwen2-vl-2b whole (28), 4 x 1024 tokens;
   phi3.5-moe at 2 layers, 4 x 1024; llama4-scout at 1 layer, 1 x 2048
   (``reduced`` logged), 3 steps each, the same printout and launch
   check, each first loss held within ``TRAIN_BF16_FIRST_LOSS_RTOL`` of an
   f32 forward of the same first batch from the same seed's weights.
   Beside the runs, started with the phase, ``python -m
   repro_torch.launch.train --arch <arch> --steps 3 --device cuda`` for
   llama3-8b, rwkv6-3b and qwen3-4b, side by side (and the mesh phase's
   dry run, host work in its own process).
9. ``mesh``: the multi-device layer on the card's 1x1 NCCL mesh (one
   card holds one NCCL rank; ``launch.mesh.make_card_mesh``).
   qwen1.5-32b at full width with 8 of its 64 layers, bf16 weights from
   ``--seed`` placed as DTensors by ``param_pspecs``: 8 prompts of 1024
   tokens each through ``launch.steps.build_prefill_step`` at batch 1
   into its row of a batch-8, 2048-row cache (``cache_pspecs``), then 32
   greedy decode steps through ``build_decode_step``, the cache updated
   in place; the tokens must equal the unsharded forward's on the same
   weights and the logits agree within ``PARITY_ATOL``.  Then one
   sharded bf16 train step at 2 layers on 1 x 1024 tokens (ZeRO-1
   moments): its loss equal to the unsharded loss within
   ``TRAIN_LOSS_RTOL``, its parameters finite, each kernel launched as a
   step launches it.  The launches of both sharded runs (counts set to 0
   just before each, read just after) go into the kernel table.
   ``python -m repro_torch.launch.dryrun --all --arch qwen1.5-32b`` (its
   four shapes on the 16x16 and 2x16x16 production meshes over the fake
   process group, on the host, started with the train phase when it
   runs: each ok or skipped with the reference's reason, its H100
   roofline terms printed), and, started with the phase beside the
   sharded steps, ``examples/quickstart_torch.py`` and
   ``examples/train_small_torch.py`` (150 steps; the loss must drop by
   more than 0.5) on the card.

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
import functools
import gc
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
PHASES = ("build", "kernels", "parity", "serve", "calibrate", "experiments",
          "train", "mesh")

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
# flash_prefill_bwd (bf16) against autograd of the plain version in bf16:
# the kernel rounds P and dS to bf16 as the operands of dV, dK and dQ and
# reads the forward's bf16 output in delta = rowsum(dO * O); the plain
# version rounds dP and its own outputs to bf16 instead.  Where dP and
# delta nearly cancel in dS, either rounding moves an element by a share
# of the gradient's rms: the kernel's arithmetic emulated on the CPU put
# the worst element at 0.38 of dQ's rms at recurrentgemma-2b's training
# shape (0.61 of this limit) and 0.15 at llama3-8b's (0.36), with every
# gradient within 0.0039 relative L2 (tests/test_torch_attention_design.py
# at reduced T: 0.13-0.29 of the limit, 0.0038-0.0039).  So each element
# is held to 0.2 of its gradient's rms plus two bf16 steps of itself, and
# each gradient's relative L2 difference to 1e-2
TOL["grad_bf16"] = dict(atol=0.0, atol_rms=0.2, rtol=2.0 ** -6)
GRAD_BF16_REL_L2 = 1e-2
# model parity, f32 logits: cuBLAS and the kernels sum 2560- to 14336-long
# products (and rwkv6_scan its T*D-term sums) in another order than the CPU
PARITY_ATOL = 1e-3
# the MoE paths
PHI, SCOUT = "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"
# the mesh phase's model and its paths in the kernel table
QWEN32 = "qwen1.5-32b"
MESH_SERVE, MESH_TRAIN = f"mesh {QWEN32}", f"mesh train {QWEN32} bf16"
# the paper's own evaluation models (configs/paper_*.py), each served under
# one of its Table-4 traffic mixes (simulator/workload.WORKLOADS)
LLAMA30, CODELLAMA, QWEN72 = "llama-30b", "codellama2-34b", "qwen2-72b"
PAPER_TRAFFIC = {LLAMA30: "sharegpt", CODELLAMA: "longbench",
                 QWEN72: "alpaca"}
# one whole paper-model instance, and the 32k-token contexts (the
# reference's prefill_32k / decode_32k length) of llama3-8b and its
# sliding-window variant, in the kernel table
LLAMA_SW = "llama3-8b-sw"
WHOLE_PATH = f"whole {CODELLAMA}"
LONG_PATH, LONG_SW_PATH = "32k llama3-8b", f"32k {LLAMA_SW}"
# the reference's long_500k shape (launch/input_specs.py): a decode step at
# batch 1 over a 524288-position context, for the archs whose blocks all
# see a bounded context (cfg.subquadratic); each serves one such context
LONG500 = 524288
LONG500_ARCHS = ("rwkv6-3b", "recurrentgemma-2b", LLAMA_SW, SCOUT)
L500 = {arch: f"500k {arch}" for arch in LONG500_ARCHS}


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


# timed calls a measurement: 10, so that the run keeps inside its time
# limit with every training path
TIMED_CALLS = 10


def cuda_ms(torch, fn, iters: int = TIMED_CALLS, warmup: int = 2,
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


def timed_call(torch, fn):
    """(``fn()``, its ms on CUDA events): one call, for a plain version
    that takes seconds, timed where its output is made for the check."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def cuda_ms_cold(torch, fn, flush, iters: int = TIMED_CALLS) -> float:
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


# elements a slice of the leaf-by-leaf comparisons and of the largest
# outputs': their f64 temporaries stay near 0.5 GB, where a whole leaf of
# llama4-scout (its 202048-row embedding or head, 1.03B elements) would take
# 8.3 GB each
SLICE = 1 << 26


def flat_slices(*xs):
    """Aligned slices of at most ``SLICE`` elements of equally sized
    tensors, flattened (views)."""
    flat = [x.reshape(-1) for x in xs]
    for i in range(0, flat[0].numel(), SLICE):
        yield [f[i:i + SLICE] for f in flat]


def sq_sum(torch, x) -> float:
    """Sum of squares of ``x`` in f64 on the card, a slice at a time."""
    return float(sum((s.to("cuda").double().square().sum()
                      for (s,) in flat_slices(x)), torch.zeros((),
                     dtype=torch.float64, device="cuda")))


def compare(torch, got, want, tol_name: str):
    """(ok, max |got - want|, largest share of its limit an element uses).
    Outputs of more than ``SLICE`` elements (the 524288-row prefills' 2.7e9)
    are compared a slice at a time, their rms summed in f64."""
    tol = TOL[tol_name]
    if want.numel() > SLICE:
        rms = (sq_sum(torch, want) / want.numel()) ** 0.5
        parts = [_compare(torch, g, w, tol, rms)
                 for g, w in flat_slices(got, want)]
        return (all(p[0] for p in parts), max(p[1] for p in parts),
                max(p[2] for p in parts))
    want = want.float()
    return _compare(torch, got, want, tol, want.square().mean().sqrt())


def _compare(torch, got, want, tol, rms):
    want = want.float()
    diff = (got.float() - want).abs()
    limit = tol["atol"] + tol["atol_rms"] * rms + tol["rtol"] * want.abs()
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
# qwen1.5-32b's prefill: 40 heads x 1024 rows x 128, 5.2M output
# elements, 1.25 times llama3-8b's served shape.  In bf16 its worst element
# against the plain version came to 1.029 of the two-step limit on an
# H100 (NVIDIA H100 80GB HBM3, 700 W; f32: 0.127): the tail of the same two
# roundings that put the bf16 training shapes' 4 times larger outputs at
# 1.08-1.21.  So, as they are, it is held to the f32 attention of the same
# inputs and must be no less accurate than the plain version
# (BF16_EXACT_SHARE_RATIO below); f32 keeps the plain-version limit.
QWEN32_PREFILL = ((QWEN32, MESH_SERVE), 1, 1024, 1024, 40, 40, 128, True,
                  0, 0)
# The paper's models at LongBench's 4096-token clip: qwen2-72b's and
# codellama2-34b's G 8 (64 heads on 8), llama-30b's 52 MHA heads; bf16
# only, the dtype that serves them (f32 runs them in phase 4's parity at
# 101 tokens, and phase 3 at 333).  They are held as qwen1.5-32b's prefill
# is, decided before their first run on the card: the kernel's algorithm
# emulated on the CPU put its
# worst element against the plain version at 1.17 of the two-step limit at
# T 4096 (4 heads) and 1.04 at 8192 (1 head), where T 1024 gives 0.82, the
# card's 0.74-0.88; against the f32 attention both at the same share, the
# output's own rounding (tests/test_torch_long_context.py)
PAPER_PREFILLS = [
    ((QWEN72, CODELLAMA, WHOLE_PATH), 1, 4096, 4096, 64, 8, 128, True, 0, 0),
    ((LLAMA30,), 1, 4096, 4096, 52, 52, 128, True, 0, 0)]
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
    # qwen1.5-32b: MHA, 40 heads (G 1), served and sharded (mesh phase);
    # its bf16 output is held as the training shapes' are (QWEN32_PREFILL)
    QWEN32_PREFILL,
    # the paper's models off the tiles (their 4096-token prefills are
    # PAPER_PREFILLS, bf16 only): G 8 (8 positions a bf16 q tile, 333
    # leaves 5) and 52 MHA heads (52 is no multiple of the 8- or 16-row
    # fragments)
    (None, 1, 333, 333, 64, 8, 128, True, 0, 0),
    (None, 1, 333, 333, 52, 52, 128, True, 0, 0),
]
# f32 only: head_dim 80 (hubert-xlarge; bf16 has no D 80 kernel) and the
# training shapes, where the f32 numbers go into the table under the
# training paths
TRAIN_HUBERT, TRAIN_LLAMA = "train hubert-xlarge", "train llama3-8b"
TRAIN_RWKV, TRAIN_RG = "train rwkv6-3b", "train recurrentgemma-2b"
TRAIN_HUBERT_BF16, TRAIN_LLAMA_BF16 = (f"{TRAIN_HUBERT} bf16",
                                       f"{TRAIN_LLAMA} bf16")
TRAIN_RWKV_BF16, TRAIN_RG_BF16 = f"{TRAIN_RWKV} bf16", f"{TRAIN_RG} bf16"
# the five decoders that train in bf16 only (phase 8)
TRAIN_QWEN3_BF16, TRAIN_GLM_BF16 = ("train qwen3-4b bf16",
                                    "train chatglm3-6b bf16")
TRAIN_VL_BF16 = "train qwen2-vl-2b bf16"
TRAIN_PHI_BF16, TRAIN_SCOUT_BF16 = f"train {PHI} bf16", f"train {SCOUT} bf16"
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
# bf16 only: the bf16 training shapes (hubert-xlarge's bf16 run computes in
# f32 from its f32 frames on, so its attention is the f32 case above).
# Their log-sum-exp is held to the f32 limit and their output must not
# change when it is written.  Their output is held to be no less accurate
# than the plain version's: against the attention of the same inputs in
# f32, the kernel's worst element within 1.1 times the plain version's
# share of the bf16 limit.  (On an H100, against each other the two
# reached 1.08-1.21 of that limit at these shapes, 4 times the served
# shapes' elements, where the served shapes give 0.74-0.88; against the
# f32 attention both gave 1.79 and 2.06, the same worst element, which
# the output's own bf16 rounding and p's take past two bf16 steps.)
BF16_EXACT_SHARE_RATIO = 1.1
FLASH_BF16_CASES = [
    # (qwen3-4b's and phi3.5-moe's training shape too: 32 heads on 8)
    ((TRAIN_LLAMA_BF16, TRAIN_QWEN3_BF16, TRAIN_PHI_BF16), 4, 1024, 1024, 32,
     8, 128, True, 0, 0),
    ((TRAIN_RG_BF16,), 1, 4096, 4096, 10, 1, 256, True, 2048, 0),
]
# bf16 only, the 32k-token prefills of the 32k paths (the reference's
# prefill_32k length): llama3-8b causal, and llama3-8b-sw's 8192 window.
# The plain version runs over LONG_PLAIN_ROWS query rows at a time
# (flash_prefill_plain_chunked: a 32768 x 32768 score matrix a head would
# take 137 GB); held as PAPER_PREFILLS are (the emulation's worst element
# against the plain version grows with T and the elements)
LONG_FLASH_CASES = [
    ((LONG_PATH,), 1, 32768, 32768, 32, 8, 128, True, 0, 0),
    ((LONG_SW_PATH,), 1, 32768, 32768, 32, 8, 128, True, 8192, 0),
]
LONG_PLAIN_ROWS = 512
# bf16 only, the 524288-token prefills of the 500k paths: llama4-scout's G 5
# under its 8192 window (q is 2.7e9 elements, past 2^31) and
# recurrentgemma-2b's G 10 at D 256 under its 2048 window; held as the 32k
# prefills are.  No SDPA time: its mask alone would be 275 GB
LONG500_FLASH_CASES = [
    ((L500[SCOUT],), 1, LONG500, LONG500, 40, 8, 128, True, 8192, 0),
    ((L500["recurrentgemma-2b"],), 1, LONG500, LONG500, 10, 1, 256, True,
     2048, 0),
]
# every bf16-only case is held to the f32 attention, and so is
# qwen1.5-32b's prefill
FLASH_BF16_ONLY = (FLASH_BF16_CASES + PAPER_PREFILLS + LONG_FLASH_CASES
                   + LONG500_FLASH_CASES)
BF16_EXACT_CASES = FLASH_BF16_ONLY + [QWEN32_PREFILL]
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
    # qwen1.5-32b: G 1 (40 kv heads), half the ring valid
    ((QWEN32, MESH_SERVE), 8, 2048, 40, 40, 128, 1024),
]
# bf16 only, the dtype that serves them (the run's time limit keeps these
# large caches out of f32): llama4-scout's ring, the paper's models over an
# 8192-row cache (max_seq_len 8192), rows valid as LongBench's prompts
# leave them (2048-4096, ragged): G 8 (qwen2-72b, codellama2-34b; 8 splits
# of 1024 rows) and llama-30b's 52 MHA heads (2 splits of 4096: 436M
# elements a cache); the whole codellama2-34b instance (one sequence, its
# 4096-token prompt in the 8192-row cache: 64 splits of 128 rows); the 32k
# paths: 32768 rows, every one valid (1.07 GB of bf16 K/V, 9 splits of
# 3712), and llama3-8b-sw's 8192-row ring at its max_batch 2, full (as
# after the prefill that rolled it)
DECODE_BF16_CASES = [
    # llama4-scout: G = 5 over its S = 8192 ring (local attention keeps
    # the whole window whatever max_seq_len is; its f32 parity decodes
    # over a short cache): 1024 valid rows, ragged, the split edges, and
    # every row valid (as after a wrap)
    ((SCOUT,), 8, 8192, 40, 8, 128, 1024),
    (None, 8, 8192, 40, 8, 128, "ragged"),
    (None, 6, 8192, 40, 8, 128, "edges"),
    (None, 8, 8192, 40, 8, 128, 8192),
    # the paper's G 8 over an 8192-row cache on the split edges
    (None, 6, 8192, 64, 8, 128, "edges"),
    ((QWEN72, CODELLAMA), 8, 8192, 64, 8, 128, (2048, 4096)),
    ((LLAMA30,), 8, 8192, 52, 52, 128, (2048, 4096)),
    ((WHOLE_PATH,), 1, 8192, 64, 8, 128, 4096),
    ((LONG_PATH,), 8, 32768, 32, 8, 128, 32768),
    ((LONG_SW_PATH,), 2, 8192, 32, 8, 128, 8192),
    # the 500k paths' decode steps: batch 1 over a full ring
    ((L500[SCOUT],), 1, 8192, 40, 8, 128, 8192),
    ((L500[LLAMA_SW],), 1, 8192, 32, 8, 128, 8192),
    ((L500["recurrentgemma-2b"],), 1, 2048, 10, 1, 256, 2048),
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
    if isinstance(lens, tuple):                  # (lo, hi): ragged within
        return [int(x) for x in rng.integers(lens[0], lens[1] + 1, B)]
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


# inputs larger than this are drawn on the card, from a generator seeded
# by the run's numpy stream: numpy draws ~55M normals a second, so the
# kernel checks' 2.5G elements took ~45 s of the phase on the host
HOST_DRAW_MAX = 1 << 20


def card_randn(torch, rng, shape, dtype):
    """Standard normal f32 draws of ``shape`` on the card, as ``dtype``."""
    n = 1
    for d in shape:
        n *= d
    if n <= HOST_DRAW_MAX:
        x = rng.standard_normal(shape, "float32")
        return torch.from_numpy(x).to("cuda", dtype)
    gen = torch.Generator(device="cuda").manual_seed(
        int(rng.integers(1 << 62)))
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


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
        return card_randn(torch, rng, shape, dtype)

    all_ok = True
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        esize = torch.finfo(dtype).bits // 8
        f32 = dtype == torch.float32
        for case in FLASH_CASES + (FLASH_F32_CASES if f32
                                   else FLASH_BF16_ONLY):
            paths, B, T, S, Hq, Hkv, D, causal, window, off = case
            q = randn((B, T, Hq, D), dtype)
            k = randn((B, S, Hkv, D), dtype)
            v = randn((B, S, Hkv, D), dtype)
            kw = dict(causal=causal, window=window, q_offset=off)
            huge = case in LONG500_FLASH_CASES
            long = huge or case in LONG_FLASH_CASES
            plain = (functools.partial(FP.flash_prefill_plain_chunked,
                                       rows=LONG_PLAIN_ROWS)
                     if long else FP.flash_prefill_plain)
            got = FP.flash_prefill(q, k, v, **kw)
            # (a long case's plain version takes 0.4-8 s a call: its time
            # is this call's)
            (want, want_lse), plain_ms = timed_call(
                torch, lambda: plain(q, k, v, **kw, return_lse=True))
            torch.cuda.synchronize()
            ok, err, share = compare(torch, got, want, dn)
            exact_text = ""
            if not f32 and case in BF16_EXACT_CASES:
                exact = plain(q.float(), k.float(), v.float(), **kw)
                shares = [compare(torch, x, exact, dn)[2]
                          for x in (got, want)]
                exact_text = (f"; held instead to the f32 attention of the "
                              f"same inputs: the kernel's worst element at "
                              f"{shares[0]:.3f} of the limit, the plain "
                              f"version's {shares[1]:.3f} (ratio limit "
                              f"{BF16_EXACT_SHARE_RATIO:g})")
                ok = bool(torch.isfinite(got).all()) and (
                    shares[0] <= BF16_EXACT_SHARE_RATIO * shares[1])
                del exact
            # the log-sum-exp the backward reads (f32 in both dtypes, held
            # to the f32 limit: the scores' products are exact in f32 and
            # summed in f32 on both sides), and the output unchanged by it;
            # in bf16 the f32 output the backward reads, which must round
            # to the bf16 output
            got2, lse, o_grad = FP._forward_kernel(q, k, v, causal, window,
                                                   off, True)
            torch.cuda.synchronize()
            empty = torch.isinf(want_lse)
            same_empty = torch.equal(empty, torch.isinf(lse)) and bool(
                (lse[empty] < 0).all())
            ok_l, err_l, share_l = compare(
                torch, lse.masked_fill(empty, 0.0),
                want_lse.masked_fill(empty, 0.0), "float32")
            ok = (ok and ok_l and same_empty and torch.equal(got, got2)
                  and torch.equal(o_grad.to(dtype), got))
            lse_text = (f"; lse max_abs_err={err_l:.3e} ({share_l:.3f} of "
                        f"its limit), {int(empty.sum())} empty rows -inf on "
                        f"both sides: {same_empty}")
            del got2, o_grad
            kern = lambda: FP.flash_prefill(q, k, v, **kw)  # noqa: E731
            # (a 524288-row call takes 35-260 ms: 3 timed calls each)
            few_k = dict(iters=3, warmup=1) if huge else {}
            ms = cuda_ms(torch, kern, **few_k)
            dev_ms = cuda_ms(torch, kern, spin=True, **few_k)
            lse_dev_ms = cuda_ms(torch, lambda: FP._forward_kernel(
                q, k, v, causal, window, off, True), spin=True, **few_k)
            # (SDPA with a 32768 x 32768 mask takes 63 ms: 2 timed calls)
            few = dict(iters=2, warmup=1) if long else {}
            if not long:
                plain_ms = cuda_ms(torch, lambda: plain(q, k, v, **kw))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            # (a window that no query position reaches masks nothing)
            if huge:
                lib = None
            elif causal and not off and S == T and (not window
                                                    or window >= T):
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            else:
                mask = sdpa_mask(torch, T, S, causal, window, off, dev)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
            lib_ms = lib and cuda_ms(torch, lib, **few)
            lib_dev_ms = lib and cuda_ms(torch, lib, spin=True, **few)
            nbytes = esize * (2 * B * T * Hq * D + 2 * B * S * Hkv * D)
            ops = 4 * D * B * Hq * flash_pairs(T, S, causal, window, off)
            b_ms, b_by = bound(nbytes, ops, dn)
            all_ok &= ok
            chunks = (f" (plain version over {LONG_PLAIN_ROWS}-row chunks, "
                      "its time that of the checked call)" if long else "")
            lib_text = (
                f"library_ms={lib_ms:.4f}" if lib else
                f"library_ms=null (SDPA's {T} x {S} mask alone would be "
                f"{T * S / 1e9:.0f} GB)")
            log(f"flash_prefill {dn} B={B} T={T} S={S} Hq={Hq} Hkv={Hkv} "
                f"D={D} causal={causal} window={window} q_offset={off}"
                f"{chunks}: "
                f"max_abs_err={err:.3e} ({tol_text(dn)}; worst element at "
                f"{share:.3f} of its limit{exact_text}{lse_text}) "
                f"{'ok' if ok else 'MISMATCH'} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} {lib_text} "
                f"(device: kernel {dev_ms:.4f}, with the log-sum-exp "
                f"{'and the f32 output ' if not f32 else ''}"
                f"{lse_dev_ms:.4f}"
                + (f", library {lib_dev_ms:.4f}" if lib else "") +
                f") bound_ms={b_ms:.4f} ({b_by}; share "
                f"{100 * b_ms / dev_ms:.0f}%) achieved on the device "
                f"{ops / dev_ms * 1e-9:.1f} TFLOP/s"
                + (f" (SDPA {ops / lib_dev_ms * 1e-9:.1f})" if lib else ""))
            if dtype == torch.bfloat16 or case in FLASH_F32_CASES:
                record(results, "flash_prefill", paths, max_abs_err=err,
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                       library_device_ms=lib_dev_ms)
        for case in DECODE_CASES + ([] if f32 else DECODE_BF16_CASES):
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
    all_ok &= run_long_scans(torch, rng, results)
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
    ``flash_prefill`` with a ``q_offset`` (f32 and bf16), and
    ``rwkv6_scan`` at head_dim 128 (its backward kernel takes 64).
    ``flash_prefill`` in bf16 at head_dim 80 has no kernel either way: it
    raises with grad and under ``torch.no_grad()``, launching nothing."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import rwkv6_scan as RS

    def t(*shape, dtype=torch.float32):
        return torch.rand(shape, device="cuda", dtype=dtype).requires_grad_()

    lengths = torch.tensor([3, 7], dtype=torch.int32, device="cuda")
    bf = torch.bfloat16
    calls = {
        "flash_prefill bf16 q_offset": ("flash_prefill",
                                        lambda: FP.flash_prefill(
                                            t(1, 9, 4, 64, dtype=bf),
                                            t(1, 19, 2, 64, dtype=bf),
                                            t(1, 19, 2, 64, dtype=bf),
                                            q_offset=10)),
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
    before = wrappers["flash_prefill"].launches
    for grad in (True, False):
        try:
            with torch.set_grad_enabled(grad):
                FP.flash_prefill(t(1, 9, 4, 80, dtype=bf),
                                 t(1, 9, 2, 80, dtype=bf),
                                 t(1, 9, 2, 80, dtype=bf))
        except NotImplementedError:
            pass
        else:
            fail(f"flash_prefill bf16 D 80 (grad {grad}): no kernel, yet it "
                 "did not raise")
    if wrappers["flash_prefill"].launches != before:
        fail("flash_prefill bf16 D 80: launched without a kernel")
    log("flash_prefill bf16 D 80: raises with grad and under "
        "torch.no_grad() (no bf16 kernel at head_dim 80), launching "
        "nothing: ok")
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
    ``flash_prefill`` (f32, D 64 / 80 / 128 / 256; bf16, D 128),
    ``rwkv6_scan`` (with s0 and a final-state cotangent) and ``rglru_scan``
    (with h0) return a ``grad_fn`` (their autograd Functions), and
    backward launches the backward kernel once, with the gradients of
    autograd through the plain version."""
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.kernels import rglru_scan as RG
    from repro_torch.kernels import rwkv6_scan as RS

    wrappers = kernel_wrappers()

    def carried(what, fwd, bwd, call, leaves, cots, plain, tol="grad"):
        n = (wrappers[fwd].launches, wrappers[bwd].launches)
        out = call(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        if outs[0].grad_fn is None:
            fail(f"{what}: no grad_fn")
        got = torch.autograd.grad(outs, leaves, cots)
        want = plain(*(x.detach() for x in leaves), *cots)
        torch.cuda.synchronize()
        shares = [compare(torch, g, w, tol) for g, w in zip(got, want)]
        launched = (wrappers[fwd].launches - n[0],
                    wrappers[bwd].launches - n[1])
        if launched != (1, 1) or not all(ok for ok, _, _ in shares):
            fail(f"{what}: launches (forward, backward) {launched}, "
                 f"gradients {shares}")
        log(f"{what} on inputs that require grad: grad_fn "
            f"{type(outs[0].grad_fn).__name__}, launches forward 1, "
            f"backward 1; gradients at "
            + ", ".join(f"{sh:.3f}" for _, _, sh in shares)
            + f" of their limits ({tol_text(tol)}): ok")

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
    bf = torch.bfloat16
    q, k, v = (rn(*s).to(bf).requires_grad_() for s in (
        (2, 77, 8, 128), (2, 77, 2, 128), (2, 77, 2, 128)))
    carried("flash_prefill bf16 D 128 causal=True", "flash_prefill",
            "flash_prefill_bwd", lambda q, k, v: FP.flash_prefill(q, k, v),
            (q, k, v), (rn(2, 77, 8, 128).to(bf),),
            lambda q, k, v, do: FP.flash_prefill_bwd_plain(q, k, v, do),
            tol="grad_bf16")
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
    # qwen2-vl-2b's training shape (G 6) in f32: a bf16 qwen2-vl-2b fed f32
    # patches computes in f32, its attention through this kernel
    (None, 4, 1024, 1024, 12, 2, 128, True, 0),
]
# bf16 (csrc/flash_prefill_bwd_bf16.cu, on wgmma): llama3-8b's training
# shape (also qwen3-4b's and phi3.5-moe's: 32 heads on 8), recurrentgemma-
# 2b's (the dK/dV launch whole, and split over 4 q-tile ranges), chatglm3-
# 6b's and qwen2-vl-2b's (G 16 and 6 on 2 kv heads: 64 dK/dV blocks, split
# over 4 ranges at D 128) and llama4-scout's G 5 under its 8192 window at
# T 16384, where the window bites (its plain gradient over 512-row chunks,
# flash_prefill_bwd_plain_chunked); then D 64 ragged and bidirectional, G
# 16 under a window, rows with no key, and D 256 with its dK/dV launch
# split over 3 ranges
# From T 8192 on the plain gradient runs over 512-row chunks, and the
# kernel is held to the f32 gradient of the same bf16 inputs, at the same
# bf16 limits (as the long bf16 prefills are held to the f32 attention).
# The limit's rms part is the whole gradient's, which the long rows make
# small; the first rows, with a few keys, carry gradients 13-16 times that
# rms, where the bf16 plain gradient's own rounding (of dP and of its
# outputs) takes it to 0.94 of the limit from the f32 gradient, so the two
# bf16 gradients can part by more than the limit though each is within it
# of the exact one (tests/test_torch_attention_design.py --long, one kv
# head: the kernel's algorithm 1.30 of the limit from the bf16 plain
# gradient, 0.52 from the f32 one)
BWD_LONG_T = 8192
BWD_BF16_CASES = [
    ((TRAIN_LLAMA_BF16, TRAIN_QWEN3_BF16, TRAIN_PHI_BF16), 4, 1024, 1024, 32,
     8, 128, True, 0),
    ((TRAIN_RG_BF16,), 1, 4096, 4096, 10, 1, 256, True, 2048),
    ((TRAIN_GLM_BF16,), 4, 1024, 1024, 32, 2, 128, True, 0),
    ((TRAIN_VL_BF16,), 4, 1024, 1024, 12, 2, 128, True, 0),
    ((TRAIN_SCOUT_BF16,), 1, 16384, 16384, 40, 8, 128, True, 8192),
    (None, 2, 333, 333, 8, 2, 64, True, 0),
    (None, 2, 200, 200, 16, 4, 64, False, 0),
    (None, 1, 190, 190, 32, 2, 128, True, 64),
    (None, 1, 200, 60, 4, 2, 64, True, 20),
    (None, 1, 1024, 1024, 8, 8, 256, False, 0),
]


def run_bwd_kernel(torch, rng, results) -> bool:
    """``flash_prefill_bwd`` against autograd of the plain version on the
    card, in f32 and in bf16 (its lse from the forward kernel), and
    autograd's backward through ``scaled_dot_product_attention`` (the
    forward's graph kept, the backward alone timed) as the library's
    time."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_prefill as FP

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape, dtype):
        return card_randn(torch, rng, shape, dtype)

    all_ok = True
    for case, dtype in ([(c, torch.float32) for c in BWD_CASES]
                        + [(c, torch.bfloat16) for c in BWD_BF16_CASES]):
        paths, B, T, S, Hq, Hkv, D, causal, window = case
        dn, f32 = str(dtype).split(".")[-1], dtype == torch.float32
        tol_name = "grad" if f32 else "grad_bf16"
        q, do = randn((B, T, Hq, D), dtype), randn((B, T, Hq, D), dtype)
        k, v = randn((B, S, Hkv, D), dtype), randn((B, S, Hkv, D), dtype)
        kw = dict(causal=causal, window=window)
        _, lse, o = FP._forward_kernel(q, k, v, causal, window, 0, True)
        got = FP.flash_prefill_bwd(q, k, v, o, do, lse, **kw)
        got2 = FP.flash_prefill_bwd(q, k, v, o, do, lse, **kw)
        same = all(torch.equal(a, b) for a, b in zip(got, got2))
        long_t = T >= BWD_LONG_T
        plain = (functools.partial(FP.flash_prefill_bwd_plain_chunked,
                                   rows=LONG_PLAIN_ROWS) if long_t
                 else FP.flash_prefill_bwd_plain)
        want, plain_ms = timed_call(torch, lambda: plain(q, k, v, do, **kw))
        held_to, against = want, ""
        if long_t:
            # held to the f32 gradient of the same inputs (see
            # BWD_LONG_T), the plain version's own shares beside it
            held_to = plain(*(x.float() for x in (q, k, v, do)), **kw)
            against = (
                "; held to the f32 gradient of the same inputs: the bf16 "
                "plain gradient against it at " + "/".join(
                    f"{compare(torch, w, e, tol_name)[2]:.3f}"
                    for w, e in zip(want, held_to))
                + " of the limit, the kernel against the bf16 plain "
                "gradient at " + "/".join(
                    f"{compare(torch, g, w, tol_name)[2]:.3f}"
                    for g, w in zip(got, want)))
        torch.cuda.synchronize()
        checks = [compare(torch, g, w, tol_name)
                  for g, w in zip(got, held_to)]
        rel = [float((g.double() - w.double()).norm() / w.double().norm())
               for g, w in zip(got, held_to)]
        ok = same and all(c[0] for c in checks) and (
            f32 or max(rel) <= GRAD_BF16_REL_L2)
        def kern():
            return FP.flash_prefill_bwd(q, k, v, o, do, lse, **kw)
        ms, dev_ms = cuda_ms(torch, kern), cuda_ms(torch, kern, spin=True)
        if not long_t:      # (the long case's time is its checked call's)
            plain_ms = cuda_ms(torch, lambda: plain(q, k, v, do, **kw),
                               iters=3, warmup=1)
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
        lib_ms, lib_dev_ms = (cuda_ms(torch, lib, iters=5),
                              cuda_ms(torch, lib, iters=5, spin=True))
        del out
        pairs = flash_pairs(T, S, causal, window, 0)
        ops = 10 * D * B * Hq * pairs
        # the kernels' own work: S and dP are computed in both launches
        ops_done = 14 * D * B * Hq * pairs
        esize = torch.finfo(dtype).bits // 8
        # (o and lse f32: the backward's delta takes the forward's f32 output)
        nbytes = (esize * (3 * B * T * Hq * D + 4 * B * S * Hkv * D)
                  + 4 * B * T * Hq * D + 4 * B * Hq * T)
        b_ms, b_by = bound(nbytes, ops, dn)
        err = max(c[1] for c in checks)
        all_ok &= ok
        chunks = (f", plain gradient over {LONG_PLAIN_ROWS}-row chunks"
                  if long_t else "")
        log(f"flash_prefill_bwd {dn} B={B} T={T} S={S} Hq={Hq} Hkv={Hkv} "
            f"D={D} causal={causal} window={window}{chunks} (dK/dV over "
            f"{FP.bwd_split(B, Hkv, S, D, n_sm, dtype)} q-tile ranges): "
            "dq/dk/dv "
            f"max_abs_err "
            + "/".join(f"{c[1]:.3e}" for c in checks) + " (worst elements at "
            + "/".join(f"{c[2]:.3f}" for c in checks) + f" of their limits; "
            f"{tol_text(tol_name)}; relative L2 "
            + "/".join(f"{x:.4f}" for x in rel)
            + ("" if f32 else f", limit {GRAD_BF16_REL_L2:g}")
            + f"{against}), two calls bit-identical: {same} "
            f"{'ok' if ok else 'MISMATCH'} kernel_ms={ms:.4f} (device "
            f"{dev_ms:.4f}) plain_ms={plain_ms:.4f} (autograd of the plain "
            f"forward, forward included) library_ms={lib_ms:.4f} (SDPA's "
            f"backward alone; device {lib_dev_ms:.4f}) bound_ms={b_ms:.4f} "
            f"({b_by}, 10 D operations a pair; share "
            f"{100 * b_ms / dev_ms:.0f}%) achieved on the device "
            f"{ops / dev_ms * 1e-9:.1f} TFLOP/s at 10 D, "
            f"{ops_done / dev_ms * 1e-9:.1f} at the kernels' 14 D (SDPA "
            f"{ops / lib_dev_ms * 1e-9:.1f} at 10 D)")
        if paths and not f32:
            # a training shape in bf16: each launch's device time
            log(f"flash_prefill_bwd bf16 B={B} T={T} S={S} Hq={Hq} "
                f"Hkv={Hkv} D={D}: device ms a call by launch "
                "(torch.profiler, 10 calls): " + ", ".join(
                    f"{name} {t:.4f}" for name, t in launch_times(torch, kern)))
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


# the 500k paths' scans: rwkv6-3b's (1, 524288, 40, 64) with its final
# state, against the plain chunked form (its 4096 chunks in turn), and
# recurrentgemma-2b's (1, 524288, 2560) against the plain recurrence split
# over time (rglru_scan_plain_chunked: the step loop would take 524288 steps
# of whole-tensor ops); inputs drawn on the card (1.3e9 elements each), at
# the decays of the served models (RWKV_CASES' slow ones, RGLRU_CASES'
# model range)
LONG500_SCAN_ROWS = 512


def run_long_scans(torch, rng, results) -> bool:
    import math

    from repro_torch.kernels import rglru_scan as RG
    from repro_torch.kernels import rwkv6_scan as RS

    gen = torch.Generator(device="cuda").manual_seed(
        int(rng.integers(1 << 62)))

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda").mul_(scale)

    def rand(*shape, lo, hi):
        return torch.rand(shape, generator=gen, device="cuda").mul_(
            hi - lo).add_(lo)

    few = dict(iters=3, warmup=1)
    B, T, H, D = 1, LONG500, 40, 64
    r, k, v = (randn(B, T, H, D, scale=0.5) for _ in range(3))
    w = rand(B, T, H, D, lo=0.6, hi=0.999)
    u = randn(H, D, scale=0.1)
    o, st = RS.rwkv6_scan(r, k, v, w, u)
    o2, st2 = RS.rwkv6_scan(r, k, v, w, u)
    same = bool(torch.equal(o, o2) and torch.equal(st, st2))
    del o2, st2
    (p_o, p_st), plain_ms = timed_call(
        torch, lambda: RS.rwkv6_scan_plain(r, k, v, w, u))
    ok_o, err_o, share_o = compare(torch, o, p_o, "rwkv6")
    ok_s, err_s, share_s = compare(torch, st, p_st, "rwkv6")
    del o, p_o
    kern = lambda: RS.rwkv6_scan(r, k, v, w, u)  # noqa: E731
    ms = cuda_ms(torch, kern, **few)
    dev_ms = cuda_ms(torch, kern, spin=True, **few)
    b_ms, b_by = bound(4 * (5 * B * T * H * D + H * D + B * H * D * D),
                       rwkv6_ops(B, T, H, D), "float32")
    ok_w = ok_o and ok_s and same
    log(f"rwkv6_scan float32 B={B} T={T} H={H} D={D} s0=False decay=slow "
        f"(the 500k path's prefill; against plain): o max_abs_err="
        f"{err_o:.3e} (worst element at {share_o:.3f} of its limit), final "
        f"state max_abs_err={err_s:.3e} ({share_s:.3f}) "
        f"({tol_text('rwkv6')}), two calls bit-identical: {same} "
        f"{'ok' if ok_w else 'MISMATCH'} kernel_ms={ms:.4f} (device "
        f"{dev_ms:.4f}) plain_ms={plain_ms:.4f} library_ms=null bound_ms="
        f"{b_ms:.4f} ({b_by}; share {100 * b_ms / dev_ms:.0f}%; the "
        f"kernel's passes move "
        f"{rwkv6_form_bytes(B, T, H, D, False) / 1e9:.2f} GB)")
    record(results, "rwkv6_scan", (L500["rwkv6-3b"],),
           max_abs_err=max(err_o, err_s), ms=ms, plain_ms=plain_ms,
           bound_ms=b_ms, bound_by=b_by, library_ms=None, device_ms=dev_ms,
           library_device_ms=None)
    del r, k, v, w

    d = 2560
    log_a = torch.sigmoid(randn(B, T, d)).mul_(-8.0 * math.log1p(math.e))
    b = (1.0 - torch.exp(2.0 * log_a)).clamp_(min=1e-12).sqrt_().mul_(
        randn(B, T, d))
    got = RG.rglru_scan(log_a, b)
    same = bool(torch.equal(got, RG.rglru_scan(log_a, b)))
    want, plain_ms = timed_call(torch, lambda: RG.rglru_scan_plain_chunked(
        log_a, b, chunk=LONG500_SCAN_ROWS))
    ok_g, err, share = compare(torch, got, want, "rglru")
    ok_g &= same
    del got, want
    kern = lambda: RG.rglru_scan(log_a, b)  # noqa: E731
    ms = cuda_ms(torch, kern, **few)
    dev_ms = cuda_ms(torch, kern, spin=True, **few)
    b_ms, b_by = bound(4 * 3 * B * T * d, 3 * B * T * d, "float32")
    log(f"rglru_scan float32 B={B} T={T} d={d} h0=False decay=model (the "
        f"500k path's prefill; against the plain recurrence split into "
        f"{LONG500_SCAN_ROWS}-step chunks, {RG.time_chunk(T)}-step chunks "
        f"in the kernel): max_abs_err={err:.3e} ({tol_text('rglru')}; worst "
        f"element at {share:.3f} of its limit), two calls bit-identical: "
        f"{same} {'ok' if ok_g else 'MISMATCH'} kernel_ms={ms:.4f} (device "
        f"{dev_ms:.4f}) plain_ms={plain_ms:.4f} library_ms=null bound_ms="
        f"{b_ms:.4f} ({b_by}; share {100 * b_ms / dev_ms:.0f}%)")
    record(results, "rglru_scan", (L500["recurrentgemma-2b"],),
           max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
           bound_by=b_by, library_ms=None, device_ms=dev_ms,
           library_device_ms=None)
    return ok_w and ok_g


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
        # (the plain version's call above is its warm-up: ~1.4 s a call at
        # T 4096)
        plain_ms = cuda_ms(torch, lambda: RG.rglru_scan_bwd_plain(
            la, b, h0, dy), iters=1, warmup=0)
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
def on_host_thread(fn, *args, after=None):
    """Run ``fn(*args)`` on a host thread, once the event ``after`` (if
    any) is set, so that CPU reference work runs while the main thread
    drives the card (torch's CPU ops release the GIL), one such run at a
    time.  Returns a function that waits for it and gives (its result, its
    seconds), or raises what it raised; its ``done`` event is set when
    ``fn`` returns or raises."""
    out, done = {}, threading.Event()

    def run():
        if after is not None:
            after.wait()
        t0 = time.perf_counter()
        try:
            out["value"] = fn(*args)
        except BaseException as e:     # noqa: BLE001 — re-raised below
            out["error"] = e
        out["seconds"] = time.perf_counter() - t0
        done.set()
    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["value"], out["seconds"]
    result.done = done
    return result


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
# llama4-scout's against its 12-position tiles (G 5); the paper's models'
# against the f32 kernel's 16-position tiles at G 8 and inside one
# 128-position tile at G 1 (llama-30b)
PARITY_PROMPT = {"llama3-8b": 77, LLAMA_SW: 77, "rwkv6-3b": 190,
                 "recurrentgemma-2b": 190, "qwen3-4b": 77, "chatglm3-6b": 101,
                 "qwen2-vl-2b": 77, PHI: 77, SCOUT: 101,
                 **dict.fromkeys(PAPER_TRAFFIC, 101)}
# layers of the parity runs: 2, recurrentgemma-2b's one full (RG-LRU,
# RG-LRU, local attention) cycle, or 1 for the MoE models (llama4-scout's
# f32 weights are 16.6 GB a side at one layer, 8.1 GB of them the
# 202048-row embedding and head; qwen2-72b's are 17.0 GB a side at 2
# layers, 10.0 of them its 152064-row embedding and head)
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
               (PHI, None, 0), (SCOUT, None, 0), (LLAMA_SW, None, 0),
               *((arch, None, 0) for arch in PAPER_TRAFFIC)]
# the rotary positions held card against CPU: the last 128 of a 524288-token
# prompt and the first 64 decoded after it
ROPE_POSITIONS = (LONG500 - 128, LONG500 + 64)
ROPE_ATOL = 1e-6


def run_rope_parity(torch):
    """``apply_rope`` of every long_500k arch's rotary (theta, head_dim,
    heads) on the card at positions 524160-524351 against the port's CPU
    version of the same inputs, within ``ROPE_ATOL``; and whether the
    card's frequencies (theta ** exponent in float64, rounded to f32) have
    the CPU's bits."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    pos = torch.arange(*ROPE_POSITIONS)[None]
    gen = torch.Generator().manual_seed(LONG500)
    for arch in LONG500_ARCHS:
        cfg = get_config(arch)
        if cfg.rope == "none":
            continue
        n = cfg.head_dim // 2
        x = torch.randn((1, pos.shape[1], cfg.num_heads, cfg.head_dim),
                        generator=gen)
        want = L.apply_rope(cfg, x, pos)
        got = L.apply_rope(cfg, x.cuda(), pos.cuda()).cpu()
        err = float((got - want).abs().max())
        same = torch.equal(L._rope_freqs(cfg.rope_theta, n, "cuda").cpu(),
                           L._rope_freqs(cfg.rope_theta, n, "cpu"))
        log(f"parity rope {arch} (theta {cfg.rope_theta:g}, {n} "
            f"frequencies, {cfg.num_heads} heads) at positions "
            f"{ROPE_POSITIONS[0]}-{ROPE_POSITIONS[1] - 1}, f32: max |card - "
            f"cpu| = {err:.3e} (tol {ROPE_ATOL:g}); frequencies bit-equal "
            f"on both sides: {same}")
        if not err <= ROPE_ATOL:
            fail(f"rope {arch}: card and CPU differ by {err:.3e} at "
                 f"positions past {LONG500 - 128}")


def long500_decode(torch, rng, cfg, p_gpu, p_cpu):
    """The long_500k step: one decode step at batch 1 and cache_len 524287
    (position 524287, ring row 524287 % window) from a cache drawn from the
    seed (full rings, conv histories, h, shifts and RWKV states), f32, on
    the card and on the CPU: logits and every cache tensor within
    ``PARITY_ATOL``."""
    from repro_torch.models import forward, init_cache

    cache_cpu = init_cache(cfg, 1, LONG500 + 32, torch.float32, "cpu")
    for t in cache_cpu.values():
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape, "float32")))
    cache_gpu = {key: t.to("cuda", copy=True)
                 for key, t in cache_cpu.items()}
    tok = torch.tensor([[int(rng.integers(2, cfg.vocab_size - 1))]])
    cl = torch.full((1,), LONG500 - 1, dtype=torch.int32)
    with torch.no_grad():
        lg_gpu, c_gpu = forward(p_gpu, cfg, {"tokens": tok.cuda()},
                                cache=cache_gpu, cache_len=cl.cuda())
        lg_cpu, c_cpu = forward(p_cpu, cfg, {"tokens": tok}, cache=cache_cpu,
                                cache_len=cl)
    errs = {"logits": float((lg_gpu.cpu() - lg_cpu).abs().max())}
    errs.update({key: float((c_gpu[key].cpu() - c_cpu[key]).abs().max())
                 for key in c_cpu})
    shapes = {key: list(t.shape) for key, t in c_cpu.items()}
    shown = {key: f"{v:.3e}" for key, v in errs.items()}
    log(f"parity {cfg.name} long_500k decode step (batch 1, cache_len "
        f"{LONG500 - 1}, cache {json.dumps(shapes)} drawn from the seed), "
        f"f32: max |card - cpu| {json.dumps(shown)} (tol {PARITY_ATOL}); "
        f"token card {int(lg_gpu[0, 0].argmax())} cpu "
        f"{int(lg_cpu[0, 0].argmax())}")
    bad = {k: v for k, v in errs.items() if not v <= PARITY_ATOL}
    if bad or not bool(torch.isfinite(lg_gpu).all()):
        fail(f"{cfg.name} long_500k decode step: card and CPU differ: {bad}")


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

    def same(self, torch) -> bool:
        """Whether both sides made as many routing calls and chose the same
        experts in each."""
        return len(self.calls["cuda"]) == len(self.calls["cpu"]) and all(
            torch.equal(ec.cpu(), eh) for (_, ec), (_, eh) in zip(
                self.calls["cuda"], self.calls["cpu"]))

    def summary(self, torch, k: int) -> str:
        """Each side's smallest top-k margin (k-th minus (k+1)-th logit of
        a token), whether the chosen experts match call by call, and the
        largest router-logit difference."""
        def margins(side):
            out = [lg.sort(-1, descending=True).values.cpu()
                   for lg, _ in self.calls[side]]
            return torch.cat([v[:, k - 1] - v[:, k] for v in out])
        pairs = list(zip(self.calls["cuda"], self.calls["cpu"]))
        same = self.same(torch)
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


def run_parity(torch, rng, seed, arch, window=None, n_patches=0,
               after=None):
    """One prompt and 8 greedy decode steps of ``arch`` at full width, f32,
    on the card and (on a host thread, once ``after`` is set) on the CPU
    from the same weights; returns ``finish``, which waits for the CPU,
    compares, and runs the row's other checks (a MoE arch's ``moe_block``
    without a host sync, a long_500k arch's decode step at cache_len
    524287); ``finish.cpu_done`` is set when the CPU's run ends."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    n_layers = PARITY_LAYERS.get(arch, 2)
    cfg = dataclasses.replace(get_config(arch), num_layers=n_layers)
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    if cfg.is_moe or arch in PAPER_TRAFFIC:
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
    # the first torch.exp of a CPU process can come out less accurate on
    # part of its tensor (ROADMAP Queue 3): one call before the reference
    torch.exp(torch.zeros(64))
    # a MoE arch's routing logged on both sides (a MoE row runs alone)
    routes = RouteLog(layers) if cfg.is_moe else None
    if routes:
        routes.__enter__()
    # the CPU's run on a host thread while the card's runs
    cpu_run = on_host_thread(greedy, torch, p_cpu, cfg, prompt, 8, "cpu",
                             patches, after=after)
    t0 = time.perf_counter()
    tok_gpu, lg_gpu = greedy(torch, p_gpu, cfg, prompt, 8, "cuda", patches)
    t_gpu = time.perf_counter() - t0

    def finish():
        """The CPU's run waited for and compared, the row's other checks;
        the row's weights freed."""
        nonlocal p_gpu, p_cpu
        try:
            (tok_cpu, lg_cpu), t_cpu = cpu_run()
        finally:
            if routes:
                routes.__exit__(None, None, None)
        err = float((lg_gpu - lg_cpu).abs().max())
        reduced = (f", window reduced to {window} (reduced run)" if window
                   else "")
        if n_patches:
            reduced += f", {n_patches} vision patches before the prompt"
        log(f"parity {arch} width, {n_layers} layers{reduced}, f32, prompt "
            f"{n} + 8 decode steps: max |logit diff| = {err:.3e} (tol "
            f"{PARITY_ATOL}), logit range [{float(lg_cpu.min()):.2f}, "
            f"{float(lg_cpu.max()):.2f}]; tokens card {tok_gpu} cpu "
            f"{tok_cpu}; card {t_gpu:.2f} s, cpu {t_cpu:.2f} s, side by side "
            "(host clock)")
        if cfg.is_moe:
            log(f"parity {arch} routing: {routes.summary(torch, cfg.top_k)}")
        if not (torch.isfinite(lg_gpu).all() and err <= PARITY_ATOL):
            fail(f"{arch} parity: logits differ by {err:.3e} > "
                 f"{PARITY_ATOL}")
        if tok_gpu != tok_cpu:
            fail(f"{arch} parity: greedy tokens differ between card and CPU")
        if cfg.is_moe:
            check_moe_no_sync(torch, p_gpu, cfg, seed)
        if arch in LONG500_ARCHS and not window:
            long500_decode(torch, rng, cfg, p_gpu, p_cpu)
        p_gpu = p_cpu = None
        torch.cuda.empty_cache()
    finish.cpu_done = cpu_run.done
    return finish


def run_parities(torch, seed):
    """``PARITY_RUNS`` in order, each dense row's card run made while the
    row before it still runs on the CPU (on a host thread; the CPU runs
    one row at a time, in order), and compared after it; a MoE row runs
    alone (it logs its routing)."""
    import numpy as np

    from repro_torch.configs import get_config

    pending = None
    for arch, window, n_patches in PARITY_RUNS:
        alone = get_config(arch).is_moe
        if alone and pending:
            pending()
            pending = None
        finish = run_parity(torch, np.random.default_rng(seed), seed, arch,
                            window, n_patches,
                            after=pending.cpu_done if pending else None)
        if pending:
            pending()
        pending = finish
        if alone:
            pending()
            pending = None
    if pending:
        pending()


# train parity: one training step, kernels on the card vs plain on the CPU;
# arch, layers, length, dtype, vision patches before the tokens
# (recurrentgemma-2b: one RG-LRU, RG-LRU, local attention cycle).  In bf16
# the archs whose attention is bf16, and qwen2-vl-2b with 64 f32 patches,
# whose bf16 weights then compute in f32 (the attention through the f32
# kernels), as the reference promotes them.  The MoE archs at 1 layer and
# in f32 only: a bf16 router moves its logits by ~1e-2, so tokens near a
# tie choose other experts on the two sides, and one token moved changes
# the gradient of an expert fed by 16-32 tokens past the bf16 leaf limit.
# llama3-8b at 1 layer, so that the run keeps inside its time limit
TRAIN_PARITY = ((PHI, 1, 256, "float32", 0),
                ("hubert-xlarge", 2, 256, "float32", 0),
                ("llama3-8b", 1, 256, "float32", 0),
                ("rwkv6-3b", 2, 256, "float32", 0),
                ("recurrentgemma-2b", 3, 256, "float32", 0),
                ("qwen3-4b", 2, 256, "float32", 0),
                ("chatglm3-6b", 2, 256, "float32", 0),
                ("qwen2-vl-2b", 2, 256, "float32", 0),
                ("llama3-8b", 1, 256, "bfloat16", 0),
                ("recurrentgemma-2b", 3, 256, "bfloat16", 0),
                ("qwen3-4b", 2, 256, "bfloat16", 0),
                ("chatglm3-6b", 2, 256, "bfloat16", 0),
                ("qwen2-vl-2b", 2, 256, "bfloat16", 0),
                ("qwen2-vl-2b", 2, 256, "bfloat16", 64),
                (SCOUT, 1, 256, "float32", 0))
# a train parity row whose f32 parameters, gradients and AdamW moments (16
# bytes a parameter) pass this runs alone: llama4-scout's 66 GB (79.6 GB
# of the card at its peak); phi3.5-moe's 25 GB runs first, its CPU side
# beside the dense rows' card steps
TRAIN_PARITY_ALONE_BYTES = 40e9
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
# bf16: the card (cuBLAS's and the kernels' bf16) and the CPU (the plain
# versions' bf16) round activations and gradients at different places, as
# the port and the JAX package do on the CPU; held at that comparison's
# limits (tests/test_torch_train_bf16.py: loss 5e-4 relative, each
# gradient leaf 0.07 relative L2, about three and two times the worst
# seen there), and each parameter after AdamW within the f32 limit plus
# one bf16 step (2^-7 of |p| at most), where the two sides' updates round
# to neighbouring bf16 values
TRAIN_BF16_LOSS_RTOL = 5e-4
TRAIN_BF16_GRAD_REL_L2 = 0.07


def adamw_limit(p_cpu, g_gpu, g_cpu, s_gpu, s_cpu, opt, p_round=2.0 ** -22,
                p_after=None):
    """Per element, how far one AdamW step from zero moments may move the
    two sides' parameters apart given their gradients: the step is
    lr * (u + wd * p) with u = g/(|g| + eps) for the clipped gradient g
    (bias corrections cancel at step 1), and |u1 - u2| <= 2 |g1 - g2| /
    (|g1| + |g2| + eps); plus 1e-5 of lr and ``p_round`` of |p| for the
    rounding of the update and the parameter (f32: 2^-22; bf16
    parameters: one bf16 step, at most 2^-7 of the larger of two
    neighbouring bf16 values, so of the largest of |p| before and
    ``p_after``, the two sides' |p| after: a zero-initialised scale is
    nonzero after)."""
    a, b = g_gpu.double() * s_gpu, g_cpu.double() * s_cpu
    du = 2 * (a - b).abs() / (a.abs() + b.abs() + opt.eps)
    p = p_cpu.double().abs()
    if p_after is not None:
        p = p.maximum(p_after.double().abs())
    return opt.lr * (du + 1e-5) + p * p_round


def grad_share(torch, gg, gc, f32: bool) -> float:
    """The card's gradient leaf ``gg`` against the CPU's ``gc`` (on the
    card), as a share of its limit: f32 element by element at
    ``TOL["train_grad"]`` (the rms of the whole leaf), bf16 by the leaf's
    relative L2 difference against ``TRAIN_BF16_GRAD_REL_L2``; inf where
    the card's leaf is not finite."""
    if not all(bool(torch.isfinite(g).all()) for (g,) in flat_slices(gg)):
        return float("inf")
    norm2 = sq_sum(torch, gc)
    if f32:
        tol = TOL["train_grad"]
        rms = (norm2 / max(1, gc.numel())) ** 0.5
        share = 0.0
        for g, w in flat_slices(gg, gc):
            diff = (g.double() - w.double()).abs()
            limit = (tol["atol"] + tol["atol_rms"] * rms
                     + tol["rtol"] * w.double().abs())
            share = max(share, float(torch.where(diff == 0, 0.0,
                                                 diff / limit).max()))
        return share
    diff2 = float(sum(((g.double() - w.double()).square().sum()
                       for g, w in flat_slices(gg, gc)),
                      torch.zeros((), dtype=torch.float64, device="cuda")))
    rel = (diff2 / norm2) ** 0.5 if norm2 else diff2 ** 0.5
    return rel / TRAIN_BF16_GRAD_REL_L2


def run_train_parity(torch, rng, seed, arch, layers, length, dtype_name,
                     n_patches=0, after=None):
    """One ``train_step``-equivalent at full width, ``layers`` layers, in
    ``dtype_name`` (with ``n_patches`` f32 vision patches before the
    tokens), batch 1 x ``length``: on the card (kernels) and on the CPU
    (plain versions) from the same weights; the card's backward and AdamW
    update under ``set_sync_debug_mode("error")``; a MoE arch's routing
    logged on both sides, the chosen experts equal in every call.  The
    card's moments are freed before the CPU step, and the two sides are
    compared leaf by leaf on the card, where the reference's AdamW step
    runs on the CPU's gradients (llama4-scout's f32 step holds 66 GB of
    parameters, gradients and moments).  The CPU's loss and gradients run
    on a host thread, once ``after`` is set; this returns, after the
    card's step, ``finish``, which waits for them and compares
    (``run_train_parities`` runs the next row's card step first), and
    whose ``cpu_done`` is set when the CPU's part ends."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, layers as L, make_loss_fn
    from repro_torch.params import tree_leaves, tree_unflatten
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import loss_and_grads, to_batch

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    dtype = getattr(torch, dtype_name)
    f32 = dtype == torch.float32
    if cfg.is_moe:
        log(f"train parity {arch}: {host_free_gb():.1f} GB of host memory "
            f"free before {cfg.param_count() * 16 / 1e9:.1f} GB of "
            f"{dtype_name} parameters, gradients and AdamW moments on each "
            "side")
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9    # (a previous row's)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p_gpu = init_params(cfg, gen, dtype, "cuda")
    p_cpu = tree_unflatten(p_gpu, iter(
        t.to("cpu", copy=True) for t in tree_leaves(p_gpu)))
    if cfg.modality == "audio":
        nb = {"frames": rng.standard_normal((1, length, cfg.frontend_dim),
                                            "float32")}
    else:
        nb = {"tokens": rng.integers(2, cfg.vocab_size - 1, (1, length))}
    if n_patches:
        nb["patches"] = rng.standard_normal((1, n_patches, cfg.frontend_dim),
                                            "float32")
    nb["labels"] = rng.integers(0, cfg.vocab_size, (1, length))
    opt = AdamW()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0

    # a MoE arch's routing logged on both sides (through a global hook: at
    # most one MoE row is in flight, run_train_parities)
    routes = RouteLog(L) if cfg.is_moe else None
    leaves = tree_leaves(p_gpu)
    for x in leaves:
        x.requires_grad_(True)
    torch.exp(torch.zeros(64))  # (ROADMAP Queue 3: the CPU's first exp)
    if routes:
        routes.__enter__()
    # the CPU's loss and gradients (the plain versions) from the same
    # weights, copied before the card's update
    cpu_run = on_host_thread(loss_and_grads, cfg, p_cpu, to_batch(nb, "cpu"),
                             after=after)
    t0 = time.perf_counter()
    loss_gpu = make_loss_fn(cfg)(p_gpu, to_batch(nb, "cuda"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads = torch.autograd.grad(loss_gpu, leaves, allow_unused=True)
        g_gpu = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        del grads
        state = opt.init(leaves)
        opt.update(g_gpu, state, leaves)
    except RuntimeError as e:
        fail(f"train parity {arch}: the backward or the update "
             f"synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {n: fn.launches for n, fn in wrappers.items()
                if fn.launches}
    del state                       # the comparison needs no moments
    torch.cuda.empty_cache()

    def finish():
        """The CPU's loss and gradients waited for, the two steps
        compared, the row's checks; the row's tensors freed."""
        nonlocal p_gpu, g_gpu, leaves, p_cpu, loss_gpu
        try:
            (loss_cpu, g_cpu), t_cpu = cpu_run()
        finally:
            if routes:
                routes.__exit__(None, None, None)
        g_cpu = tree_leaves(g_cpu)

        def clip(gs):
            n = sum(sq_sum(torch, g) for g in gs) ** 0.5
            return min(1.0, opt.grad_clip / (n + 1e-12)), n

        # the two sides are compared on the card, in the same f64 arithmetic
        # (over these models' 0.1-4.1B parameters the CPU took minutes a run),
        # one CPU leaf at a time.  The reference's AdamW step (the same
        # ``AdamW.update``, which has no kernel) runs there too, a leaf at a
        # time, on the CPU's gradients scaled by their own global clip factor:
        # each leaf's scaled norm is then within the clip, so ``update`` scales
        # it by 1 and computes what it computes on the whole tree, f32
        # elementwise as on the CPU (where the update took 10-40 s a row)
        (s_gpu, n_gpu), (s_cpu, n_cpu) = clip(g_gpu), clip(g_cpu)
        lg, lc = float(loss_gpu.detach()), float(loss_cpu)
        loss_rtol = TRAIN_LOSS_RTOL if f32 else TRAIN_BF16_LOSS_RTOL
        p_round = 2.0 ** -22 if f32 else 2.0 ** -7
        ok = abs(lg - lc) <= loss_rtol * abs(lc)
        g_share = p_share = 0.0
        for i, (gg, pg, pl) in enumerate(zip(g_gpu, leaves,
                                             tree_leaves(p_cpu))):
            gr = g_cpu[i].to("cuda")
            sh = grad_share(torch, gg, gr, f32)
            g_share = max(g_share, sh)
            p0 = pl.detach().to("cuda", copy=True)
            pr = p0.clone()
            opt.update([gr.float() * s_cpu], opt.init([pr]), [pr])
            sh_p = 0.0
            for g1, g2, a, b, before in flat_slices(gg, gr, pg.detach(), pr,
                                                    p0):
                diff = (a.double() - b.double()).abs()
                lim = adamw_limit(before, g1, g2, s_gpu, s_cpu, opt, p_round,
                                  None if f32 else torch.maximum(b.abs(),
                                                                 a.abs()))
                sh_p = max(sh_p, float((diff / lim).max()))
            p_share = max(p_share, sh_p)
            if not sh <= 1.0 or sh_p > 1.0:
                log(f"train parity {arch} {dtype_name}: leaf {i} "
                    f"{tuple(gr.shape)} gradient at {sh:.3f} of its limit, "
                    f"parameter at {sh_p:.3f}")
                ok = False
            del gr, pr, p0
        g_limit = (f"worst element at {g_share:.3f} of its limit "
                   f"({tol_text('train_grad')})" if f32 else
                   f"worst leaf at {g_share:.3f} of its limit (relative L2 "
                   f"{TRAIN_BF16_GRAD_REL_L2:g})")
        patches = (f" after {n_patches} f32 vision patches (the model "
                   "computes in f32 from them on)" if n_patches else "")
        log(f"train parity {arch} full width, {layers} layers, {dtype_name}, "
            f"batch 1 x {length}{patches}: "
            f"loss card {lg:.6f} cpu {lc:.6f} (rtol {loss_rtol}); "
            f"gradients: {len(g_cpu)} leaves, {g_limit}, global norm card "
            f"{n_gpu:.6f} cpu {n_cpu:.6f}; parameters after AdamW: worst "
            f"element at {p_share:.3f} of its limit (lr * (2|g1 - g2| / "
            f"(|g1| + |g2| + eps) + 1e-5) + {'2^-22' if f32 else '2^-7'} "
            f"|p|); backward and "
            f"update under "
            f"set_sync_debug_mode('error'): no host sync; launches "
            f"{json.dumps(launches)}; card {t_gpu:.2f} s (peak "
            f"{peak_gb:.2f} GB, {held_gb:.2f} of it the previous row's), cpu "
            f"{t_cpu:.2f} s beside it (loss and "
            "gradients; its AdamW step on the card, a leaf at a time) (host "
            "clock)")
        if cfg.is_moe:
            log(f"train parity {arch} routing (forward and recomputation): "
                f"{routes.summary(torch, cfg.top_k)}")
            if not routes.same(torch):
                fail(f"train parity {arch}: the card and the CPU chose other "
                     "experts (smallest top-k margins in the line above)")
        if not ok or not np.isfinite(lg):
            fail(f"train parity {arch} {dtype_name}: card and CPU steps "
                 "differ (lines above)")
        want = step_launches(cfg)
        if launches != want:
            fail(f"train parity {arch} {dtype_name}: launches {launches}, "
                 f"expected {want} "
                 "(per layer the forward kernel twice, for the forward and "
                 "its recomputation, and the backward kernel once)")
        del g_cpu
        p_gpu = g_gpu = leaves = p_cpu = loss_gpu = None
        gc.collect()
        torch.cuda.empty_cache()
    finish.cpu_done = cpu_run.done
    return finish


def run_train_parities(torch, seed):
    """``TRAIN_PARITY`` in order, each row's card step run while the row
    before it still computes its CPU reference on a host thread (one row's
    at a time, in order), and compared after it (the rows hold at most 30
    GB of the card and 25 GB of the host each); a row past
    ``TRAIN_PARITY_ALONE_BYTES`` runs alone.  Of the MoE rows, which log
    their routing through one global hook, only one is ever in flight."""
    import numpy as np

    from repro_torch.configs import get_config

    pending = None
    for arch, layers, length, dtype_name, n_patches in TRAIN_PARITY:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        alone = cfg.param_count() * 16 > TRAIN_PARITY_ALONE_BYTES
        if alone and pending:
            pending()
            pending = None
        finish = run_train_parity(
            torch, np.random.default_rng(seed), seed, arch, layers, length,
            dtype_name, n_patches,
            after=pending.cpu_done if pending else None)
        if pending:
            pending()
        pending = finish
        if alone:
            pending()
            pending = None
    if pending:
        pending()


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
                QWEN32: ("flash_prefill", "decode_attention"),
                PHI: ("flash_prefill", "decode_attention"),
                SCOUT: ("flash_prefill", "decode_attention"),
                LLAMA30: ("flash_prefill", "decode_attention"),
                CODELLAMA: ("flash_prefill", "decode_attention"),
                QWEN72: ("flash_prefill", "decode_attention")}
# depth of the served models.  2 instances of the whole MoE models do not
# fit one 80 GB card (83.7 GB and 203.5 GB of bf16 weights each), so they
# serve at their published width with 2 of 32 and 2 of 48 layers (5.7 and
# 12.4 GB an instance): their steps are host-bound, and the run's time
# limit, with every training path in it, asks for the fewest layers that
# still serve every kernel of the path.  The dense
# models serve at their published width with 8 layers (recurrentgemma-2b
# 9: three whole cycles of its 3-block pattern), so that the whole run
# stays well inside its time limit (with the bf16 training runs it took
# 1025.5 s of 1200 at full depth): a served
# step launches each kernel once a layer, and full-depth llama3-8b and
# qwen3-4b still serve in the calibrate phase and the API check.
# qwen1.5-32b (70.4 GB of bf16 weights: two whole instances do not fit
# either) serves at 8 of its 64 layers, 11.5 GB an instance.  The paper's
# models (65.1, 67.5 and 145.4 GB an instance whole) serve at 4 of 60, 48
# and 80 layers (5.1, 6.6 and 12.0 GB an instance; the run's time limit
# again), under their Table-4 traffic at max_seq_len PAPER_SEQ_LEN; the
# whole 48-layer codellama2-34b serves in ENGINE_PATHS
SERVE_LAYERS = {PHI: 2, SCOUT: 2, "llama3-8b": 8, "rwkv6-3b": 8,
                "recurrentgemma-2b": 9, "qwen3-4b": 8, "chatglm3-6b": 8,
                "qwen2-vl-2b": 8, QWEN32: 8, LLAMA30: 4, CODELLAMA: 4,
                QWEN72: 4}
# Table-4's prompts clip at 4096 and its outputs at 2048, and the engine
# stops a request at max_seq_len - 1: 4096 + 2048 + 1 rows fit in 8192
PAPER_SEQ_LEN = 8192


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


class FiniteCheck:
    """While installed, counts non-finite logits of the engines' forward
    and of their graphed decode steps (``DecodeGraphs.step``) on the
    device, read once after the run: the last position's row of every
    slot, the one the engine takes its argmax of (two small device ops per
    step beside the model's thousands)."""

    def __init__(self, torch):
        import repro_torch.serving.engine as engine_mod
        self.torch, self.engine_mod = torch, engine_mod
        self.real = engine_mod.forward
        self.real_step = engine_mod.DecodeGraphs.step
        self.n = torch.zeros((), dtype=torch.int64, device="cuda")

    def __enter__(self):
        def checked(*args, **kwargs):
            logits, cache = self.real(*args, **kwargs)
            self.n.add_((~self.torch.isfinite(logits[:, -1])).sum())
            return logits, cache

        def checked_step(runner, *args):
            logits, new = self.real_step(runner, *args)
            self.n.add_((~self.torch.isfinite(logits[:, -1])).sum())
            return logits, new
        self.engine_mod.forward = checked
        self.engine_mod.DecodeGraphs.step = checked_step
        return self

    def __exit__(self, *exc):
        self.engine_mod.forward = self.real
        self.engine_mod.DecodeGraphs.step = self.real_step

    @property
    def count(self) -> int:
        return int(self.n)


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
        why = ("2 instances of the whole model do not fit the card"
               if arch in (PHI, SCOUT, QWEN32, *PAPER_TRAFFIC)
               else "the run's time limit")
        reduced = f" (reduced from {cfg.num_layers}: {why})"
        cfg = dataclasses.replace(cfg, num_layers=SERVE_LAYERS[arch])
    traffic = PAPER_TRAFFIC.get(arch)
    seq_len = PAPER_SEQ_LEN if traffic else 2048
    econf = engine_mod.EngineConfig(max_batch=8, max_seq_len=seq_len,
                                    dtype=torch.bfloat16, eos_token=-1,
                                    device="cuda")
    # arrivals and lengths first, so that every path serves the same trace
    # (how many draws the tokens take depends on the vocabulary's size);
    # a paper model's lengths from its Table-4 profile
    if traffic:
        from repro_torch.simulator.workload import WORKLOADS
        times = np.concatenate([[0.0], np.cumsum(
            rng.exponential(1.0 / 4.0, 15))])
        profile = WORKLOADS[traffic]
        ins = profile.input_dist.sample(rng, 16)
        outs = profile.output_dist.sample(rng, 16)
        shape = [(float(t), int(i), int(o))
                 for t, i, o in zip(times, ins, outs)]
    else:
        traffic = "uniform 128-1024 / 16-64"
        shape, t = [], 0.0
        for i in range(16):
            shape.append((t, int(rng.integers(128, 1025)),
                          int(rng.integers(16, 65))))
            t += float(rng.exponential(1.0 / 4.0))
    reqs = [Request(rid=i, arrival_time=t, prompt_len=plen, output_len=out,
                    prompt_tokens=[int(x) for x in
                                   rng.integers(2, cfg.vocab_size - 1, plen)])
            for i, (t, plen, out) in enumerate(shape)]

    wrappers = kernel_wrappers()
    with FiniteCheck(torch) as nonfinite:
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
            kv_gb = sum(x.numel() * x.element_size() for x in
                        server.instances[0].engine.engine.cache.values()
                        ) / 1e9
        del server
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    summary = stats.summary()
    log(f"serve {arch} bf16, {cfg.num_layers} layers{reduced}, "
        f"{cfg.param_count() / 1e9:.2f}B parameters, 2 instances, max_batch"
        f" 8, max_seq_len {seq_len} ({kv_gb:.2f} GB of KV cache an "
        f"instance): {len(reqs)} requests ({traffic}, Poisson at 4 req/s),"
        f" prompts {sum(r.prompt_len for r in reqs)} tokens (longest "
        f"{max(r.prompt_len for r in reqs)}), outputs "
        f"{sum(r.output_len for r in reqs)} tokens (longest "
        f"{max(r.output_len for r in reqs)})")
    log(f"serve {arch} summary {json.dumps(summary)}")
    log(f"serve {arch} wall_s={wall:.2f} (host clock) init_s={t_init:.2f} "
        f"peak_device_gb={peak_gb:.2f} launches={json.dumps(launches)}")
    log(f"serve {arch} steps (host clock): {steps.summary(np)}")
    if nonfinite.count:
        fail(f"serve {arch}: {nonfinite.count} non-finite logits")
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


# paths that drive one ServingEngine straight (no scheduler): one whole
# codellama2-34b instance (48 layers, 67.5 GB of bf16 weights: the largest
# paper model whose whole instance one 80 GB card holds) on one LongBench
# prompt at its 4096-token clip; the 32k-token contexts, two ragged prompts
# at max_batch 2 (llama3-8b-sw's 8192-row ring rolled by the prefills,
# overwritten in place by decode); and the reference's long_500k shape:
# one 524288-token prompt drawn from the seed and 16 greedy tokens at
# max_batch 1 (the shape's batch), so that every decode step runs over a
# context of 524288 positions or more, on rwkv6-3b, recurrentgemma-2b and
# llama3-8b-sw whole and llama4-scout at its serve depth (SERVE_LAYERS: its
# whole 48 layers are 217 GB of bf16 weights).  A prefill forms the logits
# of its last position alone, as the reference's does.
# The 32k llama3-8b-sw path serves 8 of its 32 layers: its 500k path
# serves the arch whole, through the same kernels.
# path -> (arch, layers or None for all, max_batch, max_seq_len, prompt
# lengths, tokens a request)
ENGINE_PATHS = {
    WHOLE_PATH: (CODELLAMA, None, 1, PAPER_SEQ_LEN, (4096,), 32),
    LONG_PATH: ("llama3-8b", None, 2, 32832, (32704, 16411), 64),
    LONG_SW_PATH: (LLAMA_SW, 8, 2, 32832, (32704, 16411), 64),
    **{L500[arch]: (arch, SERVE_LAYERS[arch] if arch == SCOUT else None,
                    1, LONG500 + 32, (LONG500,), 16)
       for arch in LONG500_ARCHS}}
ENGINE_DEPTH_WHY = {
    LONG_SW_PATH: f"the run's time limit; {L500[LLAMA_SW]} serves it whole",
    L500[SCOUT]: "the whole model's bf16 weights do not fit the card"}
ENGINE_KERNELS = {path: PATH_KERNELS.get(ENGINE_PATHS[path][0],
                                         ("flash_prefill", "decode_attention"))
                  for path in ENGINE_PATHS}


def reckon_prefill_gb(torch, cfg, T, econf) -> float:
    """The engine's peak for a T-token prefill, reckoned from shapes: its
    weights, its cache and the most that the prefill's tensors hold at
    once, counted on meta tensors (``roofline.op_costs.OpCosts``; nothing
    is allocated), plus the scratch that the kernels allocate themselves
    (rwkv6_scan's chunk states, which its meta path does not make)."""
    from repro_torch.kernels.rwkv6_scan import KERNEL_CHUNK
    from repro_torch.models import forward, init_cache, init_params
    from repro_torch.params import tree_leaves
    from repro_torch.roofline.op_costs import OpCosts

    params = init_params(cfg, None, econf.dtype, "meta")
    cache = init_cache(cfg, econf.max_batch, econf.max_seq_len, econf.dtype,
                       "meta")
    toks = torch.zeros((1, T), dtype=torch.long, device="meta")
    with torch.no_grad(), OpCosts(live=tree_leaves(params)
                                  + tree_leaves(cache) + [toks]) as oc:
        forward(params, cfg, {"tokens": toks}, return_cache=True,
                last_only=True)
    scratch = (4 * cfg.num_heads * -(-T // KERNEL_CHUNK)
               * (cfg.head_dim ** 2 + cfg.head_dim)
               if "rwkv6" in cfg.block_pattern else 0)
    return (oc.costs.peak_live_bytes + scratch) / 1e9


def run_engine_path(torch, rng, seed, path):
    """ENGINE_PATHS[path] in bf16 at full width and its depth: every
    prompt prefilled, then decode steps until each request has its tokens
    (greedy), no logit row non-finite, the path's kernels launched (counts
    set to 0 just before the prefills, read after the last step); the peak
    device memory beside the prefill's, reckoned from shapes."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.request import Request
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    arch, layers, max_batch, seq_len, prompts, n_new = ENGINE_PATHS[path]
    cfg = get_config(arch)
    depth = "full depth"
    if layers:
        depth = (f"{layers} of its {cfg.num_layers} layers (reduced: "
                 f"{ENGINE_DEPTH_WHY[path]})")
        cfg = dataclasses.replace(cfg, num_layers=layers)
    econf = EngineConfig(max_batch=max_batch, max_seq_len=seq_len,
                         dtype=torch.bfloat16, eos_token=-1, device="cuda")
    reckoned = reckon_prefill_gb(torch, cfg, max(prompts), econf)
    reqs = [Request(rid=i, arrival_time=0.0, prompt_len=n, output_len=n_new,
                    prompt_tokens=[int(x) for x in rng.integers(
                        2, cfg.vocab_size - 1, n)])
            for i, n in enumerate(prompts)]
    wrappers = kernel_wrappers()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps = StepLog()
    with FiniteCheck(torch) as nonfinite:
        t0 = time.perf_counter()
        eng = ServingEngine(cfg, seed=seed, econf=econf, recorder=steps)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        kv_gb = sum(x.numel() * x.element_size()
                    for x in eng.cache.values()) / 1e9
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for r in reqs:
            eng.prefill(r)
        while eng.decode_step():
            pass
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        del eng
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    window = (f", window {cfg.sliding_window} (a ring of that many rows)"
              if cfg.sliding_window else "")
    log(f"{path}: {arch} bf16 at full width, {depth} ({cfg.num_layers} "
        f"layers, {cfg.param_count() / 1e9:.2f}B parameters{window}), one "
        f"ServingEngine, max_batch {max_batch}, max_seq_len {seq_len} "
        f"({kv_gb:.2f} GB of cache): prompts {list(prompts)}, {n_new} "
        f"greedy tokens each; wall_s={wall:.2f} (host clock) "
        f"init_s={t_init:.2f} peak_device_gb={peak_gb:.2f} (reckoned for "
        f"the longest prefill: {reckoned:.2f}) "
        f"launches={json.dumps(launches)}")
    log(f"{path} steps (host clock): {steps.summary(np)}")
    for r in reqs:
        log(f"{path} request {r.rid} (prompt {r.prompt_len}): first tokens "
            f"{r.generated[:8]}")
    if nonfinite.count:
        fail(f"{path}: {nonfinite.count} non-finite logits")
    short = [r.rid for r in reqs if len(r.generated) != n_new
             or not all(0 <= t < cfg.vocab_size for t in r.generated)]
    if short:
        fail(f"{path}: requests {short} lack tokens")
    for name in ENGINE_KERNELS[path]:
        if launches[name] <= 0:
            fail(f"{path}: kernel {name} was never launched on its path")
    return {name: launches[name] for name in ENGINE_KERNELS[path]}


def log_unfit(torch):
    """qwen2-72b's whole instance is not run: its bf16 weights alone are
    more than the card holds (the 4-card sharded serve is the
    multi-device layer's measurement)."""
    from repro_torch.configs import get_config

    need = get_config(QWEN72).param_count() * 2 / 1e9
    have = torch.cuda.get_device_properties(0).total_memory / 1e9
    log(f"whole {QWEN72}: not run: {need:.1f} GB of bf16 weights an "
        f"instance against the card's {have:.1f} GB")


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
# steps, dtype); each run's kernels are TRAIN_KERNELS'
# (recurrentgemma-2b at 4096 positions, so that its 2048 window bites).
# Each bf16 run is its f32 twin's shape, so that step time and memory
# compare directly; hubert-xlarge's bf16 run keeps bf16 weights but
# computes in f32 from its f32 frames on, as the reference promotes them
TRAIN_RUNS = {TRAIN_HUBERT: ("hubert-xlarge", None, 8, 1024, 5, "float32"),
              TRAIN_LLAMA: ("llama3-8b", 4, 4, 1024, 3, "float32"),
              TRAIN_RWKV: ("rwkv6-3b", None, 4, 1024, 3, "float32"),
              TRAIN_RG: ("recurrentgemma-2b", None, 1, 4096, 3, "float32")}
TRAIN_RUNS.update({f"{name} bf16": run[:-1] + ("bfloat16",)
                   for name, run in TRAIN_RUNS.items()})
# The five decoders that train in bf16 alone, at full width: depth and
# batch from 12 bytes a parameter (bf16 weights and gradients, f32 AdamW
# moments) plus activations, in the 80 GB card (qwen2-vl-2b whole, 28
# layers, 21 GB of weights and state; qwen3-4b and chatglm3-6b at 8 of 36
# and 28 layers, 19 and 26 GB; phi3.5-moe at 2 of 32, 34 GB; llama4-scout
# at 1 of 48, 50 GB, 8.1 GB of it its 202048-row embedding and head, on
# 2048 tokens so that its logits stay under 9 GB).  Each one's first loss
# is held to an f32 forward of the same first batch from the same seed's
# weights (no f32 run of these)
TRAIN_RUNS.update({
    TRAIN_QWEN3_BF16: ("qwen3-4b", 8, 4, 1024, 3, "bfloat16"),
    TRAIN_GLM_BF16: ("chatglm3-6b", 8, 4, 1024, 3, "bfloat16"),
    TRAIN_VL_BF16: ("qwen2-vl-2b", None, 4, 1024, 3, "bfloat16"),
    TRAIN_PHI_BF16: (PHI, 2, 4, 1024, 3, "bfloat16"),
    TRAIN_SCOUT_BF16: (SCOUT, 1, 1, 2048, 3, "bfloat16")})
TRAIN_KERNELS = {TRAIN_HUBERT: ("flash_prefill", "flash_prefill_bwd"),
                 TRAIN_LLAMA: ("flash_prefill", "flash_prefill_bwd"),
                 TRAIN_RWKV: ("rwkv6_scan", "rwkv6_scan_bwd"),
                 TRAIN_RG: ("rglru_scan", "rglru_scan_bwd", "flash_prefill",
                            "flash_prefill_bwd")}
TRAIN_KERNELS.update({f"{name} bf16": kernels
                      for name, kernels in TRAIN_KERNELS.items()})
BF16_ONLY_RUNS = (TRAIN_QWEN3_BF16, TRAIN_GLM_BF16, TRAIN_VL_BF16,
                  TRAIN_PHI_BF16, TRAIN_SCOUT_BF16)
TRAIN_KERNELS.update(dict.fromkeys(BF16_ONLY_RUNS, ("flash_prefill",
                                                    "flash_prefill_bwd")))
# a bf16 run's first loss against its f32 twin's: both draw one set of
# initial weights from the seed (the bf16 run's rounded to bf16), and bf16
# rounds every activation where f32 keeps 24 bits, roundings that compound
# with depth.  On the CPU's 2-layer smoke configs the two losses differed
# by at most 2.1e-4 of themselves; on an H100 by 1.6e-5 to 1.2e-3 for
# hubert-xlarge (whose compute stays f32), llama3-8b and rwkv6-3b, and by
# 1.29e-2 for recurrentgemma-2b (26 layers, 4096 tokens); the limit is
# about twice that
TRAIN_BF16_FIRST_LOSS_RTOL = 3e-2
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
            # the card's activity alone: the busy share sums the
            # kernels' device time, and the host's op events took 5-11 s
            # a run to collect and aggregate (the same busy ms either way)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
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


def f32_first_loss(torch, cfg, batch, seed) -> float:
    """The loss of ``batch`` under f32 weights drawn as ``train`` draws
    them from ``seed``, forward only: the f32 reference of a bf16 run
    that has no f32 twin."""
    from repro_torch.models import init_params, make_loss_fn
    from repro_torch.training.train_loop import to_batch

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, torch.float32, "cuda")
    with torch.no_grad():
        loss = float(make_loss_fn(cfg)(params, to_batch(batch, "cuda")))
    log(f"train {cfg.name} float32 forward of the first batch from the "
        f"seed's weights ({cfg.num_layers} layers, "
        f"{cfg.param_count() * 4 / 1e9:.1f} GB): loss {loss:.5f} "
        f"({time.perf_counter() - t0:.1f} s)")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return loss


def run_train(torch, rng, seed, name, smi, first_losses):
    """One ``train`` run of ``TRAIN_RUNS``; ``first_losses`` maps each
    arch to its f32 run's first loss (this run's is added where it is f32,
    and a bf16 run's is held to it)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (ByteTokenizer, TokenDataset,
                                           synthetic_corpus)
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import train

    arch, layers, B, T, steps, dtype_name = TRAIN_RUNS[name]
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
        if dtype_name != "float32" and arch not in first_losses:
            first_losses[arch] = f32_first_loss(
                torch, cfg, next(ds.batches(B, T, seed=seed)), seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    clock = StepClock(torch, batches, steps)
    t0 = time.perf_counter()
    opt = AdamW(lr=TRAIN_LR)
    _, losses = train(cfg, clock, steps=steps, optimizer=opt, seed=seed,
                      dtype=getattr(torch, dtype_name), log_every=1,
                      log_fn=lambda m: log(f"train {arch} {dtype_name}: "
                                           f"{m}"), device="cuda")
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
    log(f"train {arch} {dtype_name}, {cfg.num_layers} layers{reduced}, "
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
    log(f"train {arch} {dtype_name} profiled step, device ms by kernel: "
        f"{top}; the port's kernels: {own}")
    if not all(np.isfinite(losses)):
        fail(f"{name}: losses {losses} not finite")
    if dtype_name == "float32":
        if not losses[-1] < losses[0]:
            fail(f"{name}: losses {losses} not falling")
        first_losses[arch] = losses[0]
    else:
        twin = first_losses.get(arch)
        falls = losses[-1] < losses[0]
        log(f"{name}: first loss {losses[0]:.5f} against the f32 "
            f"{'forward' if name in BF16_ONLY_RUNS else 'twin'}'s {twin} "
            f"(rtol {TRAIN_BF16_FIRST_LOSS_RTOL:g}); the loss "
            f"{'falls' if falls else 'does not fall'} from the first step "
            f"to the last")
        if twin is None or abs(losses[0] - twin) > (
                TRAIN_BF16_FIRST_LOSS_RTOL * abs(twin)):
            fail(f"{name}: first loss {losses[0]} against the f32 "
                 f"twin's {twin}")
    want = {n: [c] for n, c in step_launches(cfg).items()}
    if per_step != want:
        fail(f"{name}: launches per step {per_step}, expected {want}")
    return {n: sum(c[n] for c in launches) for n in TRAIN_KERNELS[name]}


TRAIN_CLI_ARCHS = ("llama3-8b", "rwkv6-3b", "qwen3-4b")


def start_train_cli():
    """Start the launcher's own check: ``python -m repro_torch.launch.train
    --arch <arch> --steps 3 --device cuda`` (its smoke config) for each of
    ``TRAIN_CLI_ARCHS``, side by side (each spends most of its ~24 s
    starting up), while the train runs use the card.  Returns (start time,
    processes) for ``finish_train_cli``."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return time.perf_counter(), {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--steps", "3", "--device", "cuda"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in TRAIN_CLI_ARCHS}


def finish_train_cli(started):
    """Wait for ``start_train_cli``'s processes: each must exit 0 with its
    loss improved."""
    t0, procs = started
    for arch, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        for line in out.strip().splitlines():
            log(f"train cli {arch}: {line}")
        if proc.returncode != 0 or "(improved)" not in out:
            fail(f"python -m repro_torch.launch.train --arch {arch} "
                 f"failed (exit {proc.returncode}): {err[-2000:]}")
        log(f"train cli {arch}: exit 0, "
            f"{time.perf_counter() - t0:.1f} s after the start")


# --------------------------------------------------------------------- #
# phase 9: the multi-device layer on the card's 1x1 mesh
# --------------------------------------------------------------------- #
MESH_LAYERS, MESH_TRAIN_LAYERS = 8, 2
# tests/test_torch_train.py's ADAMW_ATOL, under the mesh step's bound
MESH_ADAMW_ATOL = 1e-6
MESH_PROMPT, MESH_BATCH, MESH_ROWS, MESH_STEPS = 1024, 8, 2048, 32
MESH_KERNELS = {MESH_SERVE: ("flash_prefill", "decode_attention"),
                MESH_TRAIN: ("flash_prefill", "flash_prefill_bwd")}


def mesh_greedy(torch, cfg, prompts, prefill, decode):
    """Each prompt through ``prefill`` (batch 1) into its row of a
    (MESH_BATCH, MESH_ROWS) cache, then MESH_STEPS greedy decode steps of
    the whole batch: (tokens (steps + 1, B), logits (steps, B, V)).
    ``prefill(toks)`` -> (last logits (1, V), one-sequence cache) and
    ``decode(cache, tok, lens)`` -> (logits (B, V), cache) are the
    sharded steps or the plain forward."""
    from repro_torch.models import init_cache, write_slot
    cache = init_cache(cfg, MESH_BATCH, MESH_ROWS, torch.bfloat16, "cuda")
    firsts = []
    for i, prompt in enumerate(prompts):
        last, pc = prefill(prompt)
        write_slot(cache, pc, i, MESH_PROMPT)
        firsts.append(last.argmax(-1))
    tok = torch.stack(firsts).reshape(MESH_BATCH, 1)
    tokens, logits = [tok[:, 0]], []
    cache = decode.place(cache)
    for s in range(MESH_STEPS):
        lens = torch.full((MESH_BATCH,), MESH_PROMPT + s, dtype=torch.int32,
                          device="cuda")
        out, cache = decode(cache, tok, lens)
        logits.append(out)
        tok = out.argmax(-1, keepdim=True)
        tokens.append(tok[:, 0])
    return torch.stack(tokens), torch.stack(logits)


def run_mesh(torch, seed):
    """qwen1.5-32b at full width through the port's multi-device layer on
    the card's 1x1 NCCL mesh (``launch.mesh.make_card_mesh``): its bf16
    weights (``MESH_LAYERS`` layers, drawn from ``seed``) placed by
    ``param_pspecs`` as DTensors; 8 prompts of 1024 tokens, each through
    ``build_prefill_step`` at batch 1 into its row of a batch-8 cache of
    2048 rows (placed by ``cache_pspecs``), then 32 greedy decode steps
    through ``build_decode_step``: tokens equal to the unsharded path's on
    the same weights, logits within PARITY_ATOL.  Then one sharded bf16
    train step at ``MESH_TRAIN_LAYERS`` layers and 1024 tokens through
    ``build_train_step`` (ZeRO-1 moments, ``opt_state_pspecs``): its loss
    equal to the unsharded loss's within TRAIN_LOSS_RTOL, and its updated
    parameters and moments held leaf by leaf against one unsharded AdamW
    step from the same weights (``mesh_update_shares``), each kernel's
    launches as a step's.  The launches of the sharded runs (all
    counts set to 0 just before each, read just after) go into the
    kernel table."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.input_specs import InputShape
    from repro_torch.launch.mesh import make_card_mesh, mesh_info
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          build_train_step, init_opt_state,
                                          place_batch, place_cache,
                                          place_params)
    from repro_torch.models import forward, init_params
    from repro_torch.models.spmd import P, full, place
    from repro_torch.params import tree_leaves
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import loss_and_grads

    wrappers = kernel_wrappers()
    mesh = make_card_mesh()
    full_cfg = get_config(QWEN32)
    cfg = dataclasses.replace(full_cfg, num_layers=MESH_LAYERS)
    log(f"mesh: {QWEN32} bf16 on a {tuple(mesh.shape)} "
        f"{mesh.device_type} mesh {mesh.mesh_dim_names} (NCCL, world "
        f"size 1), {cfg.num_layers} of {full_cfg.num_layers} layers at "
        f"full width (reduced: the run's time limit), "
        f"{cfg.param_count() / 1e9:.2f}B parameters")
    rng = np.random.default_rng(seed)
    prompts = [torch.as_tensor(rng.integers(2, cfg.vocab_size - 1,
                                            (1, MESH_PROMPT)),
                               device="cuda") for _ in range(MESH_BATCH)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, torch.bfloat16, "cuda")
    mi = mesh_info(mesh, global_batch=MESH_BATCH)
    mi1 = mesh_info(mesh, global_batch=1)
    pre_fn, _, _ = build_prefill_step(
        cfg, mi1, InputShape("mesh", MESH_PROMPT, 1, "prefill"),
        torch.bfloat16)
    dec_fn, _, _ = build_decode_step(
        cfg, mi, InputShape("mesh", MESH_ROWS, MESH_BATCH, "decode"),
        torch.bfloat16)
    pd1, pd = place_params(cfg, params, mi1), place_params(cfg, params, mi)
    if any(a.to_local().data_ptr() != b.data_ptr() for a, b in
           zip(tree_leaves(pd), tree_leaves(params))):
        fail("mesh: the 1x1 mesh's parameters are not the weights "
             "themselves")

    def prefill_sharded(toks):
        last, pc = pre_fn(pd1, place_batch(cfg, {"tokens": toks}, mi1))
        return full(last)[0], {k: full(v) for k, v in pc.items()}

    def decode_sharded(cache, tok, lens):
        out, cache = dec_fn(pd, cache, place(tok, P(mi.batch_axes or None,
                                                    None), mesh),
                            place(lens, P(mi.batch_axes or None), mesh))
        return full(out), cache
    decode_sharded.place = lambda c: place_cache(cfg, c, mi)

    def prefill_plain(toks):
        with torch.no_grad():
            logits, pc = forward(params, cfg, {"tokens": toks},
                                 return_cache=True)
        return logits[0, -1], pc

    def decode_plain(cache, tok, lens):
        with torch.no_grad():
            out, cache = forward(params, cfg, {"tokens": tok}, cache=cache,
                                 cache_len=lens)
        return out[:, 0], cache
    decode_plain.place = lambda c: c

    out = {}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok_s, log_s = mesh_greedy(torch, cfg, prompts, prefill_sharded,
                               decode_sharded)
    torch.cuda.synchronize()
    t_sh = time.perf_counter() - t0
    out[MESH_SERVE] = {n: wrappers[n].launches
                       for n in MESH_KERNELS[MESH_SERVE]}
    t0 = time.perf_counter()
    tok_p, log_p = mesh_greedy(torch, cfg, prompts, prefill_plain,
                               decode_plain)
    torch.cuda.synchronize()
    t_pl = time.perf_counter() - t0
    err = float((log_s.float() - log_p.float()).abs().max())
    same = bool(torch.equal(tok_s, tok_p))
    log(f"mesh serve {QWEN32}: {MESH_BATCH} prefills of {MESH_PROMPT} "
        f"tokens at batch 1, {MESH_STEPS} greedy decode steps at batch "
        f"{MESH_BATCH} over {MESH_ROWS} rows: sharded {t_sh:.2f} s, "
        f"unsharded {t_pl:.2f} s (host clock); tokens equal: {same}; max "
        f"|logits sharded - unsharded| = {err:.3e} (limit {PARITY_ATOL}); "
        f"launches {json.dumps(out[MESH_SERVE])}")
    if not same or not err <= PARITY_ATOL:
        fail(f"mesh serve {QWEN32}: the sharded path disagrees with the "
             "unsharded one")
    if not torch.isfinite(log_s.float()).all():
        fail(f"mesh serve {QWEN32}: non-finite logits")
    want = {"flash_prefill": MESH_BATCH * cfg.num_layers,
            "decode_attention": MESH_STEPS * cfg.num_layers}
    if out[MESH_SERVE] != want:
        fail(f"mesh serve {QWEN32}: launches {out[MESH_SERVE]}, want "
             f"{want}")
    del params, pd, pd1, log_s, log_p
    gc.collect()
    torch.cuda.empty_cache()

    # one sharded bf16 train step at MESH_TRAIN_LAYERS layers
    tcfg = dataclasses.replace(full_cfg, num_layers=MESH_TRAIN_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(tcfg, gen, torch.bfloat16, "cuda")
    toks = torch.as_tensor(rng.integers(2, tcfg.vocab_size - 1,
                                        (1, MESH_PROMPT)), device="cuda")
    batch = {"tokens": toks, "labels": toks}
    loss_plain, grads = loss_and_grads(tcfg, params, batch)
    loss_plain = float(loss_plain)
    opt = AdamW(lr=TRAIN_LR)
    # the unsharded step on a copy of the same weights
    p_ref = [p.detach().clone() for p in tree_leaves(params)]
    m_ref = opt.update(tree_leaves(grads), opt.init(p_ref), p_ref)[1].m
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    mi1 = mesh_info(mesh, global_batch=1)
    pd = place_params(tcfg, params, mi1)
    state = init_opt_state(tcfg, pd, mi1)
    step, _, _ = build_train_step(
        tcfg, mi1, InputShape("mesh", MESH_PROMPT, 1, "train"),
        torch.bfloat16, opt)
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    pd, state, loss = step(pd, state, place_batch(tcfg, batch, mi1))
    loss = float(full(loss))
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    out[MESH_TRAIN] = {n: wrappers[n].launches
                       for n in MESH_KERNELS[MESH_TRAIN]}
    want = step_launches(tcfg)
    peak = torch.cuda.max_memory_allocated()
    p_share, m_share = mesh_update_shares(
        torch, opt, [full(p) for p in tree_leaves(pd)],
        [full(m) for m in state.m], p_ref, m_ref)
    log(f"mesh train {QWEN32} bf16, {tcfg.num_layers} layers, 1 x "
        f"{MESH_PROMPT} tokens, {tcfg.param_count() / 1e9:.2f}B "
        f"parameters: sharded loss {loss:.6f}, unsharded {loss_plain:.6f} "
        f"(rtol {TRAIN_LOSS_RTOL}); step {t_step:.2f} s (host clock, the "
        f"first); peak device memory {peak / 1e9:.2f} GB; against one "
        f"unsharded AdamW step: worst moment leaf at {m_share:.3f} of its "
        f"limit (relative L2 {TRAIN_BF16_GRAD_REL_L2:g}), worst parameter "
        f"element at {p_share:.3f} of its limit ({MESH_ADAMW_ATOL:g} + lr "
        f"* (2|g1 - g2| / (|g1| + |g2| + eps) + 1e-5) + 2^-7 |p|); "
        f"launches {json.dumps(out[MESH_TRAIN])}")
    if not abs(loss - loss_plain) <= TRAIN_LOSS_RTOL * abs(loss_plain):
        fail(f"mesh train {QWEN32}: sharded loss {loss} != {loss_plain}")
    if not (p_share <= 1.0 and m_share <= 1.0):
        fail(f"mesh train {QWEN32}: the sharded update differs from the "
             "unsharded one (line above)")
    if out[MESH_TRAIN] != {n: want[n] for n in MESH_KERNELS[MESH_TRAIN]}:
        fail(f"mesh train {QWEN32}: launches {out[MESH_TRAIN]}, want "
             f"{want}")
    del params, pd, state, p_ref, m_ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_update_shares(torch, opt, p_sh, m_sh, p_ref, m_ref,
                       chunk=1 << 26):
    """How far the sharded step's parameters and first moments are from
    the unsharded step's, each as its worst share of its limit: a moment
    leaf (the clipped gradient times 1 - b1 after one step from zero) by
    its relative L2 difference against TRAIN_BF16_GRAD_REL_L2; a bf16
    parameter element against MESH_ADAMW_ATOL plus ``adamw_limit`` from
    the two sides' clipped gradients (their moments over 1 - b1) and one
    bf16 step of the larger of the two.  A NaN anywhere gives inf.  In
    chunks, in f64, on the card."""
    def worst(a, x):
        return max(a, x) if x == x else float("inf")

    p_share = m_share = 0.0
    with torch.no_grad():
        for ps, ms, pr, mr in zip(p_sh, m_sh, p_ref, m_ref):
            d2 = n2 = 0.0
            flat = [t.reshape(-1) for t in (ps, ms, pr, mr)]
            for i in range(0, flat[0].numel(), chunk):
                a, b, c, e = (t[i:i + chunk].double() for t in flat)
                g_sh, g_ref = b / (1 - opt.b1), e / (1 - opt.b1)
                d2 += float((b - e).square().sum())
                n2 += float(e.square().sum())
                lim = MESH_ADAMW_ATOL + adamw_limit(
                    c, g_sh, g_ref, 1.0, 1.0, opt, 2.0 ** -7, a)
                p_share = worst(p_share, float(((a - c).abs() / lim).max()))
            rel = (d2 / n2) ** 0.5 if n2 else d2 ** 0.5
            m_share = worst(m_share, rel / TRAIN_BF16_GRAD_REL_L2)
    return p_share, m_share


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def start_dryruns():
    """Start ``python -m repro_torch.launch.dryrun --all --arch
    qwen1.5-32b``: its four shapes on the 16x16 and 2x16x16 production
    meshes over the fake process group (meta tensors, on the host).
    Returns (start time, {name: process}) for ``finish_dryruns``."""
    return time.perf_counter(), {"dryrun": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--arch", QWEN32, "--out", str(ROOT / "build" / "dryrun")],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)}


def finish_dryruns(started):
    """Wait for the dry run and print each line with its H100 roofline
    terms; every pair must be ok or skipped with the reference's
    reason."""
    t0, (proc,) = started[0], started[1].values()
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail("python -m repro_torch.launch.dryrun took more than 600 s")
    for line in out.strip().splitlines():
        log(f"dryrun {line}")
    if proc.returncode != 0:
        fail(f"python -m repro_torch.launch.dryrun failed (exit "
             f"{proc.returncode}): {err[-3000:]}")
    log(f"dryrun: exit 0, {time.perf_counter() - t0:.1f} s after its "
        "start")


def start_examples():
    """Start ``examples/quickstart_torch.py`` and
    ``examples/train_small_torch.py`` (its full 150 steps; it asserts the
    loss drops by more than 0.5) on the card, side by side.  Returns (start
    time, processes) for ``finish_examples``."""
    return time.perf_counter(), {script: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / script), "--device",
         "cuda"], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for script in ("quickstart_torch.py", "train_small_torch.py")}


def finish_examples(started):
    """Wait for ``start_examples``' processes: each must exit 0."""
    t0, procs = started
    for script, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            fail(f"examples/{script} took more than 600 s")
        for line in out.strip().splitlines():
            log(f"example {script}: {line}")
        if proc.returncode != 0:
            fail(f"examples/{script} failed (exit {proc.returncode}): "
                 f"{err[-2000:]}")
        log(f"example {script}: exit 0, "
            f"{time.perf_counter() - t0:.1f} s after the start")


def stop(*started):
    """Kill whatever still runs of the (start time, {name: process}) that
    the ``start_*`` functions return (a failed phase leaves none
    behind)."""
    for item in started:
        for proc in (item[1].values() if item else ()):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


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
    paths = [arch for arch, names in {**PATH_KERNELS, **ENGINE_KERNELS,
                                      **CALIBRATE_KERNELS, **TRAIN_KERNELS,
                                      **MESH_KERNELS}.items()
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
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "wgmma")) \
                or line.startswith("=="):
            log(f"  {line.strip()}")

    results = {}     # kernel -> served path -> numbers at its main shape
    launches = {}    # kernel -> served path -> launches in its serve
    t_phase = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        log(f"phase {name}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    if "kernels" in phases:
        run_kernels(torch, np.random.default_rng(args.seed), results)
        phase_done("kernels")
    if "parity" in phases:
        run_rope_parity(torch)
        run_parities(torch, args.seed)
        run_train_parities(torch, args.seed)
        phase_done("parity")
    if "serve" in phases:
        for arch in PATH_KERNELS:
            counts = run_serve(torch, np.random.default_rng(args.seed),
                               args.seed, arch)
            for name, n in counts.items():
                launches.setdefault(name, {})[arch] = n
        run_api(torch, args.seed)
        for path in ENGINE_PATHS:
            counts = run_engine_path(torch, np.random.default_rng(args.seed),
                                     args.seed, path)
            for name, n in counts.items():
                launches.setdefault(name, {})[path] = n
        log_unfit(torch)
        phase_done("serve")
    if "calibrate" in phases:
        for name, n in run_calibrate(torch, args.seed, smi).items():
            launches.setdefault(name, {})[CALIBRATE_PATH] = n
        phase_done("calibrate")
    if "experiments" in phases:
        run_experiments(args.seed, smi)
        phase_done("experiments")
    # host work in processes of its own, run while the card trains: the
    # mesh phase's dry run (on meta tensors) and the training CLIs; the
    # examples beside the mesh phase's sharded steps
    dry = cli = examples = None
    try:
        if "train" in phases:
            if "mesh" in phases:
                dry = start_dryruns()
            cli = start_train_cli()
            first_losses = {}
            for name in TRAIN_RUNS:
                counts = run_train(torch, np.random.default_rng(args.seed),
                                   args.seed, name, smi, first_losses)
                for kname, n in counts.items():
                    launches.setdefault(kname, {})[name] = n
            finish_train_cli(cli)
            phase_done("train")
        if "mesh" in phases:
            dry = dry or start_dryruns()
            examples = start_examples()
            for path, counts in run_mesh(torch, args.seed).items():
                for kname, n in counts.items():
                    launches.setdefault(kname, {})[path] = n
            finish_examples(examples)
            finish_dryruns(dry)
            phase_done("mesh")
    finally:
        stop(dry, cli, examples)
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
