#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 profile_port.py [--seed N] [--phases sweep,steps]

``sweep``: ``decode_attention`` (bf16) at llama3-8b's and
recurrentgemma-2b's decode shapes, half-full and full, for every split size
in ``SPLIT_SIZES`` beside the one ``split_rows`` picks: device time
(``chip_smoke.cuda_ms`` behind a GPU spin, so no host time is in it), the
error against the plain version, and each of the picked size's two passes'
device time from ``torch.profiler``.  ``chip_smoke.py`` phase 3 times the
kernels against their plain versions and ``scaled_dot_product_attention``.

``steps``: one full-depth bf16 ``ServingEngine`` per attention path
(llama3-8b, recurrentgemma-2b), random weights from ``--seed``: a
1024-token prefill, then decode steps at batch 8 with 1024-token contexts,
each under ``torch.profiler``.  Prints the host-clock time of the step
(ending in the engine's own device read), the summed device time of its
kernels, their share of the step (the rest is the device idle, waiting on
the host), and the kernels that take the most device time.  It uses only
the engine's public calls, so it also runs against an older tree's
``src/`` (copy the script there).

Imports neither ``jax`` nor the JAX package.  Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

from chip_smoke import cuda_ms, log

ROOT = pathlib.Path(__file__).resolve().parent
SPLIT_SIZES = (64, 128, 256, 512)


def kernel_times(prof, n: int):
    """[(kernel name, device ms per call)] of a profile over n calls."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type.name != "CUDA" or not ev.device_time_total:
            continue
        rows.append((ev.key, ev.device_time_total / 1e3 / n))
    return sorted(rows, key=lambda r: -r[1])


def profiled(torch, fn, n: int = 1):
    """(host-clock ms per call, kernel_times) of ``fn``: n calls timed on
    the host clock after a warm-up, then n more under the profiler (whose
    own host overhead stays out of the first figure)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return wall, kernel_times(prof, n)


def short(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:70]


def run_sweep(torch, seed: int) -> None:
    from repro_torch.kernels import decode_attention as DA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for arch, B, S, Hq, Hkv, D, L in (
            ("llama3-8b", 8, 2048, 32, 8, 128, 1024),
            ("llama3-8b", 8, 2048, 32, 8, 128, 2048),
            ("recurrentgemma-2b", 8, 2048, 10, 1, 256, 1024),
            ("recurrentgemma-2b", 8, 2048, 10, 1, 256, 2048)):
        q, kc, vc = randn(B, Hq, D), randn(B, S, Hkv, D), randn(B, S, Hkv, D)
        ln = torch.full((B,), L, dtype=torch.int32, device=dev)
        want = DA.decode_attention_plain(q, kc, vc, ln).float()
        picked = DA.split_rows(B, Hkv, S, n_sm)
        sweep = []
        for rows in sorted(set(SPLIT_SIZES) | {picked}):
            def at(rows=rows):
                return DA.run_kernel(q, kc, vc, ln, rows)
            err = float((at().float() - want).abs().max())
            sweep.append(f"{rows}: {cuda_ms(torch, at, spin=True):.4f} ms "
                         f"(max |err| {err:.1e})")
        _, passes = profiled(
            torch, lambda: DA.run_kernel(q, kc, vc, ln, picked), n=10)
        log(f"decode_attention bf16 {arch} B={B} S={S} valid={L} Hq={Hq} "
            f"Hkv={Hkv} D={D}, device ms by split size (rows): "
            + "; ".join(sweep) + f"; picked {picked}, passes: "
            + ", ".join(f"{short(n)} {t:.4f} ms" for n, t in passes))


def run_steps(torch, seed: int) -> None:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.request import Request
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    rng = np.random.default_rng(seed)
    for arch in ("llama3-8b", "recurrentgemma-2b"):
        cfg = get_config(arch)
        econf = EngineConfig(max_batch=8, max_seq_len=2048,
                             dtype=torch.bfloat16, eos_token=-1,
                             device="cuda")
        eng = ServingEngine(cfg, seed=seed, econf=econf)

        def request(i, n):
            return Request(rid=i, arrival_time=0.0, prompt_len=n,
                           output_len=10 ** 6, prompt_tokens=[
                               int(x) for x in
                               rng.integers(2, cfg.vocab_size - 1, n)])

        for i in range(8):                      # 8 slots of 1024 tokens
            eng.prefill(request(i, 1024))

        def prefill_slot_0():                   # the slot's request anew
            req = eng.slot_req[0]
            eng.release(req)
            eng.prefill(req)

        wall, ks = profiled(torch, prefill_slot_0, n=3)
        report(arch, "prefill of 1024 tokens", wall, ks)
        for _ in range(3):
            eng.decode_step()
        wall, ks = profiled(torch, eng.decode_step, n=5)
        report(arch, "decode step at batch 8, contexts ~1030", wall, ks)
        del eng
        torch.cuda.empty_cache()


def report(arch, what, wall, kernels) -> None:
    busy = sum(t for _, t in kernels)
    top = ", ".join(f"{short(n)} {t:.3f}" for n, t in kernels[:6])
    log(f"step {arch} {what}: {wall:.2f} ms on the host clock, device busy "
        f"{busy:.2f} ms ({100 * busy / wall:.0f}%, idle "
        f"{100 * (1 - busy / wall):.0f}%); top kernels (ms): {top}")


PHASES = {"sweep": run_sweep, "steps": run_steps}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")

    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        raise SystemExit(1)
    sys.path.insert(0, str(ROOT / "src"))
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60).stdout.strip())
    for phase in phases:
        PHASES[phase](torch, args.seed)


if __name__ == "__main__":
    main()
