#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--phases build,kernels,parity,serve]

Phases, in order (all by default):

1. ``nvidia-smi``: the card's name and power limit.
2. ``build``: compile ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``
   into the git-ignored ``build/kernels/`` and load the library.
3. ``kernels``: each hand-written kernel against its plain PyTorch version
   on the card, in bf16 and f32, over ragged lengths, T and S that are not
   multiples of the tiles, and GQA groups of 4 and 5; prints the error
   against the tolerance and the kernel's, the plain version's and
   ``scaled_dot_product_attention``'s times beside the least time the card
   could take (``bound_ms``).
4. ``parity``: llama3-8b at full width, 2 layers, f32: one prompt and 8
   greedy decode steps with the kernels on the card and with the plain
   versions on the CPU; logits within a stated tolerance, tokens equal.
5. ``serve``: the main path. ``PaDGServer(backend="real")`` serves 16
   requests on two instances of full-depth bf16 llama3-8b (``max_batch``
   8, ``max_seq_len`` 2048) on a wall clock; every request must finish
   with its token count, no logit may be NaN or infinite, and both
   kernels' launch counts (set to 0 just before the run) must be > 0.

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
# model parity, f32 logits: cuBLAS and the kernels sum 4096- to 14336-long
# products in another order than the CPU
PARITY_ATOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes: float, ops: float, dtype_name: str):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of the inputs' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, dtype_name: str):
    """(ok, max |got - want|, largest share of its limit an element uses)."""
    tol = TOL[dtype_name]
    want = want.float()
    diff = (got.float() - want).abs()
    limit = (tol["atol"] + tol["atol_rms"] * want.square().mean().sqrt()
             + tol["rtol"] * want.abs())
    max_abs = float(diff.max()) if diff.numel() else 0.0
    share = float((diff / limit).max()) if diff.numel() else 0.0
    ok = bool(torch.isfinite(got).all()) and share <= 1.0
    return ok, max_abs, share


def tol_text(dtype_name: str) -> str:
    t = TOL[dtype_name]
    return (f"tol {t['atol']:g} + {t['atol_rms']:g}*rms + "
            f"{t['rtol']:.4g}*|plain|")


# --------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------- #
FLASH_CASES = [  # B, T, S, Hq, Hkv, D, causal, window, q_offset
    (1, 1024, 1024, 32, 8, 128, True, 0, 0),    # llama3-8b prefill (main)
    (1, 1000, 1000, 32, 8, 128, True, 0, 0),    # T, S not tile multiples
    (2, 200, 200, 10, 2, 128, True, 0, 0),      # G = 5
    (2, 128, 128, 8, 2, 64, True, 0, 0),        # D = 64
    (1, 64, 190, 4, 2, 64, True, 0, 126),       # chunked prefill offset
    (1, 160, 160, 4, 2, 64, True, 32, 0),       # sliding window
    (1, 128, 100, 4, 4, 64, False, 0, 0),       # bidirectional, S != T
]
DECODE_CASES = [  # B, S, Hq, Hkv, D, lengths ("ragged" or a fixed count)
    (8, 2048, 32, 8, 128, 1024),                # llama3-8b decode (main)
    (8, 2048, 32, 8, 128, "ragged"),
    (4, 1000, 4, 4, 128, "ragged"),             # S not a tile multiple
    (1, 512, 10, 2, 64, "ragged"),              # G = 5
    (2, 256, 8, 2, 64, "ragged"),
]


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


def run_kernels(torch, rng, results):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_prefill as FP

    dev = torch.device("cuda")

    def randn(shape, dtype):
        x = rng.standard_normal(shape, "float32")
        return torch.from_numpy(x).to(dev, dtype)

    all_ok = True
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        esize = torch.finfo(dtype).bits // 8
        for case in FLASH_CASES:
            B, T, S, Hq, Hkv, D, causal, window, off = case
            q = randn((B, T, Hq, D), dtype)
            k = randn((B, S, Hkv, D), dtype)
            v = randn((B, S, Hkv, D), dtype)
            kw = dict(causal=causal, window=window, q_offset=off)
            got = FP.flash_prefill(q, k, v, **kw)
            want = FP.flash_prefill_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            ok, err, share = compare(torch, got, want, dn)
            ms = cuda_ms(torch, lambda: FP.flash_prefill(q, k, v, **kw))
            plain_ms = cuda_ms(
                torch, lambda: FP.flash_prefill_plain(q, k, v, **kw))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if causal and not window and not off and S == T:
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            else:
                mask = sdpa_mask(torch, T, S, causal, window, off, dev)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
            lib_ms = cuda_ms(torch, lib)
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
                f"bound_ms={b_ms:.4f} ({b_by})")
            if case is FLASH_CASES[0] and dtype == torch.bfloat16:
                results["flash_prefill"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        for case in DECODE_CASES:
            B, S, Hq, Hkv, D, lens = case
            q = randn((B, Hq, D), dtype)
            kc = randn((B, S, Hkv, D), dtype)
            vc = randn((B, S, Hkv, D), dtype)
            if lens == "ragged":
                lengths = rng.integers(1, S + 1, B)
                lengths[0] = 1                    # a fresh slot's one key
            else:
                lengths = [lens] * B
            ln = torch.tensor(list(lengths), dtype=torch.int32, device=dev)
            got = DA.decode_attention(q, kc, vc, ln)
            want = DA.decode_attention_plain(q, kc, vc, ln)
            torch.cuda.synchronize()
            ok, err, share = compare(torch, got, want, dn)
            ms = cuda_ms(torch, lambda: DA.decode_attention(q, kc, vc, ln))
            plain_ms = cuda_ms(
                torch, lambda: DA.decode_attention_plain(q, kc, vc, ln))
            mask = torch.arange(S, device=dev)[None] < ln[:, None]
            mask = mask[:, None, None]
            qt = q[:, :, None]
            kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
            n_valid = int(sum(int(x) for x in lengths))
            nbytes = esize * (2 * B * Hq * D + 2 * n_valid * Hkv * D) + 4 * B
            ops = 4 * Hq * D * n_valid
            b_ms, b_by = bound(nbytes, ops, dn)
            all_ok &= ok
            log(f"decode_attention {dn} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                f"lengths={lens} (sum {n_valid}): max_abs_err={err:.3e} "
                f"({tol_text(dn)}; worst element at {share:.3f} of its "
                f"limit) {'ok' if ok else 'MISMATCH'} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by})")
            if case is DECODE_CASES[0] and dtype == torch.bfloat16:
                results["decode_attention"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    if not all_ok:
        fail("a kernel disagrees with its plain version (lines above)")


# --------------------------------------------------------------------- #
# phase 4: model parity, kernels on the card vs plain versions on the CPU
# --------------------------------------------------------------------- #
def greedy(torch, params, cfg, prompt, n_new, device):
    from repro_torch.models import forward, init_cache

    T = len(prompt)
    toks = torch.tensor([prompt], dtype=torch.long, device=device)
    logits, pc = forward(params, cfg, {"tokens": toks}, return_cache=True)
    cache = init_cache(cfg, 1, T + n_new + 1, torch.float32, device)
    cache["k"][:, :, :T] = pc["k"]
    cache["v"][:, :, :T] = pc["v"]
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


def run_parity(torch, rng, seed):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p_gpu = init_params(cfg, gen, torch.float32, "cuda")

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu()

    p_cpu = to_cpu(p_gpu)
    prompt = [int(x) for x in rng.integers(2, cfg.vocab_size - 1, 77)]
    t0 = time.perf_counter()
    tok_gpu, lg_gpu = greedy(torch, p_gpu, cfg, prompt, 8, "cuda")
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok_cpu, lg_cpu = greedy(torch, p_cpu, cfg, prompt, 8, "cpu")
    t_cpu = time.perf_counter() - t0
    err = float((lg_gpu - lg_cpu).abs().max())
    log(f"parity llama3-8b width, 2 layers, f32, prompt 77 + 8 decode "
        f"steps: max |logit diff| = {err:.3e} (tol {PARITY_ATOL}), "
        f"logit range [{float(lg_cpu.min()):.2f}, {float(lg_cpu.max()):.2f}]"
        f"; tokens card {tok_gpu} cpu {tok_cpu}; card {t_gpu:.2f} s, "
        f"cpu {t_cpu:.2f} s (host clock)")
    if not (torch.isfinite(lg_gpu).all() and err <= PARITY_ATOL):
        fail(f"model parity: logits differ by {err:.3e} > {PARITY_ATOL}")
    if tok_gpu != tok_cpu:
        fail("model parity: greedy tokens differ between card and CPU")
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


def run_serve(torch, rng, seed):
    import numpy as np

    import repro_torch.serving.engine as engine_mod
    from repro_torch.configs import get_config
    from repro_torch.core.request import Request
    from repro_torch.core.slo import SLO
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_prefill as FP
    from repro_torch.serving.padg_server import PaDGServer
    from repro_torch.serving.replay import WallClock

    cfg = get_config("llama3-8b")
    econf = engine_mod.EngineConfig(max_batch=8, max_seq_len=2048,
                                    dtype=torch.bfloat16, eos_token=-1,
                                    device="cuda")
    reqs, t = [], 0.0
    for i in range(16):
        plen = int(rng.integers(128, 1025))
        reqs.append(Request(
            rid=i, arrival_time=t, prompt_len=plen,
            output_len=int(rng.integers(16, 65)),
            prompt_tokens=[int(x) for x in
                           rng.integers(2, cfg.vocab_size - 1, plen)]))
        t += float(rng.exponential(1.0 / 4.0))

    # count non-finite logits on the device, read once after the run; only
    # the last position's row, the one the engine takes its argmax of (two
    # small device ops per step beside the model's thousands)
    nonfinite = torch.zeros((), dtype=torch.int64, device="cuda")
    real_forward = engine_mod.forward

    def checked_forward(*args, **kwargs):
        logits, cache = real_forward(*args, **kwargs)
        nonfinite.add_((~torch.isfinite(logits[:, -1])).sum())
        return logits, cache

    engine_mod.forward = checked_forward
    try:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        steps = StepLog()
        with PaDGServer(cfg, n_instances=2, slo=SLO(ttft=60.0, tpot=10.0),
                        econf=econf, seed=seed, recorder=steps) as server:
            t_init = time.perf_counter() - t0
            FP.flash_prefill.launches = 0
            DA.decode_attention.launches = 0
            t0 = time.perf_counter()
            stats = server.serve(reqs, clock=WallClock(1.0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"flash_prefill": FP.flash_prefill.launches,
                        "decode_attention": DA.decode_attention.launches}
    finally:
        engine_mod.forward = real_forward
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary = stats.summary()
    log(f"serve llama3-8b bf16, 2 instances, max_batch 8, max_seq_len "
        f"2048: {len(reqs)} requests, prompts "
        f"{sum(r.prompt_len for r in reqs)} tokens, outputs "
        f"{sum(r.output_len for r in reqs)} tokens")
    log(f"serve summary {json.dumps(summary)}")
    log(f"serve wall_s={wall:.2f} (host clock) init_s={t_init:.2f} "
        f"peak_device_gb={peak_gb:.2f} launches={json.dumps(launches)}")
    log(f"serve steps (host clock): {steps.summary(np)}")
    n_bad = int(nonfinite)
    if n_bad:
        fail(f"serve: {n_bad} non-finite logits")
    if summary["finished"] != len(reqs) or stats.rejected:
        fail(f"serve: {summary['finished']} of {len(reqs)} finished")
    short = [r.rid for r in stats.finished
             if len(r.generated) != r.output_len]
    if short:
        fail(f"serve: requests {short} lack tokens")
    for name, n in launches.items():
        if n <= 0:
            fail(f"serve: kernel {name} was never launched on the main path")
    return launches


# --------------------------------------------------------------------- #
KERNEL_META = {
    "flash_prefill": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill.py:82"),
    "decode_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:64"),
}


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
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    results = {name: dict(max_abs_err=None, ms=None, plain_ms=None,
                          bound_ms=None, bound_by=None, library_ms=None)
               for name in KERNEL_META}
    launches = {name: None for name in KERNEL_META}   # measured by serve
    if "kernels" in phases:
        run_kernels(torch, np.random.default_rng(args.seed), results)
    if "parity" in phases:
        run_parity(torch, np.random.default_rng(args.seed), args.seed)
    if "serve" in phases:
        launches = run_serve(torch, np.random.default_rng(args.seed),
                             args.seed)
    log(f"total {time.perf_counter() - t_start:.1f} s")

    table = {"kernels": [
        {"name": name, **KERNEL_META[name], "launches": launches[name],
         **results[name]} for name in KERNEL_META]}
    log(json.dumps(table))
    if set(phases) != set(PHASES):
        log(f"partial run ({','.join(phases)}): no result line")
        return
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
