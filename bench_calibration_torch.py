#!/usr/bin/env python3
"""Sim-to-real calibration of the PyTorch port: replay the checked-in
Azure/BurstGPT trace excerpts through the port's PaDG server, record
per-op step timings, fit cost-model constants, and report prediction
error before vs after.

The port's counterpart of ``benchmarks/bench_calibration.py``, with the
same structure (``trace_requests``, ``analytic_model``,
``build_report(backend)``, ``run``); it imports ``repro_torch`` only.

* **fake** (default, deterministic): the JAX bench's cell exactly — both
  excerpts at 10 req/s, 20 records each, the ``FakeEngine`` under a
  ``VirtualClock`` measuring a ``SyntheticTruth`` warp of llama-30b on
  the L20 at tp 4.  Its ``CalibrationReport`` equals the JAX bench's to
  the bit.
* **--real**: llama3-8b at its full published config in bf16, weights
  drawn from ``--seed``, served by ``PaDGServer(backend="real")`` on two
  instances (``max_batch`` 8, ``max_seq_len`` 2048) on the GPU.  Traffic:
  the first 24 records of each excerpt, each normalised to 4 req/s,
  prompts clipped to 1024 tokens and outputs to 1024, so that a prompt
  and its output fit ``max_seq_len``: every output but one (2048) is the
  record's own.  One unrecorded warm-up pass serves the same prompt
  lengths with other tokens and outputs cut to 32 (a decode step has one
  shape whatever its context, so longer outputs would warm nothing
  more); then a ``CalibrationRecorder`` is attached to every engine and
  the recorded pass runs on a wall clock.  The unfitted model is the engines' own seed
  model, ``InstanceCostModel(cfg, hw=H100_SXM)``.  Step times are host
  clock after each step's argmax read, so host dispatch is in them.
  ``--device cpu`` runs the same flow on the JAX bench's tiny config in
  f32; ``cuda`` without a card raises.

The saved report feeds the simulator runner's calibrated-executor axis
(``ExperimentRunner(..., calibration=(None, "report.json"))``);
``writeback_runner(path)`` builds the port's grid of it::

    PYTHONPATH=src python bench_calibration_torch.py
    PYTHONPATH=src python bench_calibration_torch.py --real --device cpu
    python3 bench_calibration_torch.py --real [--seed N] [--out PATH]
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.obs.events import Tracer  # noqa: E402
from repro_torch.serving.calibration import (CalibrationRecorder,  # noqa: E402
                                             CalibrationReport,
                                             SyntheticTruth)
from repro_torch.serving.padg_server import PaDGServer, ServeStats  # noqa: E402
from repro_torch.serving.replay import (SlotConfig, VirtualClock,  # noqa: E402
                                        WallClock, requests_from_trace)
from repro_torch.simulator.cost_model import (GPU_L20,  # noqa: E402
                                              HardwareProfile,
                                              InstanceCostModel)
from repro_torch.traces import load_fixture, normalize_rate  # noqa: E402

FIXTURES = ("azure", "burstgpt")

# the deterministic cell (benchmarks/bench_calibration.py's): both
# excerpts, rate-normalized so the replay finishes quickly under the
# virtual clock
FIXTURE_RATE = 10.0
PER_FIXTURE_LIMIT = 20
MAX_PROMPT, MAX_OUTPUT = 120, 12
SLOT = SlotConfig(max_batch=4, max_seq_len=160)
SERVE_SLO = SLO(ttft=2.0, tpot=0.2)

# the synthetic ground truth the fake backend 'measures': an affine warp
# of the analytic model (faster decode, slower prefill, small offsets)
TRUTH_WARP = dict(prefill_scale=1.4, prefill_offset=3e-4,
                  decode_scale=0.75, decode_offset=2e-4)

# the real cell: the serve smoke's rate; the records' own outputs, clipped
# only where a prompt and its output would overrun max_seq_len (one Azure
# record asks for 2048); enough records that the decode batches fill to
# max_batch, and few enough that the longest output (1024 steps) sets the
# pass's length, about a minute
REAL_ARCH = "llama3-8b"
REAL_RATE = 4.0
REAL_PER_FIXTURE = 24
REAL_INSTANCES = 2
REAL_MAX_BATCH, REAL_MAX_SEQ_LEN = 8, 2048
REAL_MAX_PROMPT = 1024
REAL_MAX_OUTPUT = REAL_MAX_SEQ_LEN - REAL_MAX_PROMPT
REAL_WARM_OUTPUT = 32
REAL_SLO = SLO(ttft=60.0, tpot=10.0)


def trace_requests() -> List[Request]:
    records = []
    for name in FIXTURES:
        recs = normalize_rate(load_fixture(name), FIXTURE_RATE)
        records.extend(recs[:PER_FIXTURE_LIMIT])
    return requests_from_trace(records, max_prompt=MAX_PROMPT,
                               max_output=MAX_OUTPUT, seed=0)


def analytic_model() -> InstanceCostModel:
    from repro_torch.configs import get_config
    return InstanceCostModel(cfg=get_config("llama-30b"), hw=GPU_L20, tp=4)


# --------------------------------------------------------------------- #
def real_config(device: str):
    """llama3-8b at its published config on the GPU; on the CPU the JAX
    bench's tiny config (2 layers, d_model 128, vocabulary 300)."""
    from repro_torch.configs import get_config, get_smoke_config
    if device == "cpu":
        return dataclasses.replace(
            get_smoke_config(REAL_ARCH), num_layers=2, d_model=128,
            num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256,
            vocab_size=300)
    return get_config(REAL_ARCH)


def real_requests(vocab_size: int, seed: int,
                  max_output: int = REAL_MAX_OUTPUT) -> List[Request]:
    records = []
    for name in FIXTURES:
        recs = normalize_rate(load_fixture(name), REAL_RATE)
        records.extend(recs[:REAL_PER_FIXTURE])
    return requests_from_trace(records, max_prompt=REAL_MAX_PROMPT,
                               max_output=max_output,
                               vocab_size=vocab_size, seed=seed)


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@dataclasses.dataclass
class RealRun:
    """A recorded serve: its samples, requests, stats, unfitted model and
    the flight recorder of the recorded pass."""
    recorder: CalibrationRecorder
    requests: List[Request]
    stats: ServeStats
    seed_model: InstanceCostModel
    meta: Dict
    tracer: Tracer

    def report(self) -> CalibrationReport:
        return CalibrationReport.build(self.recorder, self.seed_model,
                                       like=self.seed_model, meta=self.meta)


def serve_real(device: str = "cuda", seed: int = 0,
               before_recorded: Optional[Callable[[], None]] = None
               ) -> RealRun:
    """Warm up, then serve the recorded pass with a ``CalibrationRecorder``
    on every engine and a flight recorder (``Tracer``) on the server and
    the recorder.  ``before_recorded`` runs just before the recorded pass
    (after the warm-up)."""
    import torch

    from repro_torch.serving.engine import H100_SXM, EngineConfig

    cfg = real_config(device)
    dtype = torch.float32 if device == "cpu" else torch.bfloat16
    econf = EngineConfig(max_batch=REAL_MAX_BATCH,
                         max_seq_len=REAL_MAX_SEQ_LEN, dtype=dtype,
                         eos_token=-1, device=device)
    seed_model = InstanceCostModel(cfg=cfg, hw=H100_SXM)
    reqs = real_requests(cfg.vocab_size, seed)
    # the warm-up serves the same prompt lengths with other tokens,
    # unrecorded: the first calls of each shape pay for allocator growth
    # and library set-up that the recorded steps should not carry
    warm = real_requests(cfg.vocab_size, seed + 1, REAL_WARM_OUTPUT)
    rec = CalibrationRecorder()
    trc = Tracer()
    # the server hands its tracer only to a recorder given at construction;
    # this one joins the engines after the warm-up, so it gets it here
    rec.tracer = trc
    with PaDGServer(cfg, n_instances=REAL_INSTANCES, slo=REAL_SLO,
                    econf=econf, seed=seed, backend="real") as server:
        server.serve(warm, clock=WallClock(1.0))
        for inst in server.instances:
            inst.engine.engine.recorder = rec
        if before_recorded is not None:
            before_recorded()
        stats = server.serve(reqs, clock=WallClock(1.0), tracer=trc)
    meta = {"backend": "real", "arch": REAL_ARCH, "device": device,
            "card": card_name() if device != "cpu" else None,
            "dtype": str(dtype).replace("torch.", ""),
            "num_layers": cfg.num_layers, "d_model": cfg.d_model,
            "fixtures": list(FIXTURES), "rate": REAL_RATE,
            "n_requests": len(reqs), "finished": len(stats.finished),
            "fit": fit_forms(rec), "decode_spread": decode_spread(rec)}
    return RealRun(rec, reqs, stats, seed_model, meta, trc)


def build_report(backend: str = "fake", device: str = "cuda",
                 seed: int = 0) -> CalibrationReport:
    if backend == "fake":
        model = analytic_model()
        rec = CalibrationRecorder()
        truth = SyntheticTruth(base=model, **TRUTH_WARP)
        server = PaDGServer(None, n_instances=2, slo=SERVE_SLO, econf=SLOT,
                            backend="fake", executor=model, recorder=rec,
                            true_model=truth)
        reqs = trace_requests()
        stats = server.serve(reqs, clock=VirtualClock())
        server.shutdown()
        meta = {"backend": "fake", "truth": TRUTH_WARP,
                "fixtures": list(FIXTURES),
                "rate": FIXTURE_RATE, "n_requests": len(reqs),
                "finished": len(stats.finished)}
        return CalibrationReport.build(rec, model, like=model, meta=meta)
    return serve_real(device, seed).report()


# --------------------------------------------------------------------- #
def writeback_runner(report_path, seed: int = 0,
                     n_workers: Optional[int] = 1):
    """The simulator grid that compares the strategies on a report's fit
    (``calibration=report_path``) and on the analytic model (``None``),
    cell for cell under one seed, over both trace excerpts.  DistServe and
    MoonCake are left out: their KV links read ``cost.hw``, which a fitted
    executor lacks.  The runner's hardware table has no H100 row, so the
    analytic cells are GPU_L20's roofline, and a fitted cell takes its KV
    capacity and transfer geometry from that model."""
    from repro_torch.simulator.runner import ExperimentRunner
    return ExperimentRunner(
        strategies=("ecoserve", "vllm", "sarathi"),
        scenarios=tuple(f"trace:{name}" for name in FIXTURES),
        rates=(1.0, 2.0, 4.0, 8.0), calibration=(None, str(report_path)),
        model=REAL_ARCH, hw="L20", tp=1, pp=1, n_instances=2,
        workload="sharegpt", duration=24.0, warmup=3.0, base_seed=seed,
        n_workers=n_workers)


# --------------------------------------------------------------------- #
def fit_forms(rec: CalibrationRecorder) -> Dict[str, str]:
    """Which form ``fit_constants`` fits each op with, by its own tests:
    ``lstsq`` (the linear fit) or ``median`` (its per-token fallback on
    degenerate samples)."""
    design = np.array([(1, b, c) for b, c, _ in rec.decode]).reshape(-1, 3)
    return {"prefill": ("lstsq" if len({t for t, _ in rec.prefill}) >= 2
                        else "median"),
            "decode": ("lstsq" if len(design) >= 3
                       and np.linalg.matrix_rank(design) == 3
                       else "median")}


def decode_spread(rec: CalibrationRecorder) -> Dict[str, Dict[str, List]]:
    """The decode samples' spread, which the decode fit rests on: for each
    batch size, and for each context sum in bins of 1024 tokens (keyed by
    the bin's lower edge), the steps' count and the 10th, 50th and 90th
    percentiles of their time in ms."""
    def by(key) -> Dict[str, List]:
        groups: Dict[int, List[float]] = {}
        for b, c, dt in rec.decode:
            groups.setdefault(key(b, c), []).append(dt * 1e3)
        return {str(k): [len(v), *np.percentile(v, [10, 50, 90]).tolist()]
                for k, v in sorted(groups.items())}
    return {"batch": by(lambda b, c: b),
            "ctx_sum": by(lambda b, c: c // 1024 * 1024)}


def implied_efficiencies(constants: Dict[str, float], cfg,
                         hw: HardwareProfile) -> Dict[str, Optional[float]]:
    """The efficiencies of ``hw`` that the fitted constants imply, through
    the cost model's own terms: ``prefill_eff`` from the per-token prefill
    time (2 x active parameters of work a token), ``decode_bw_eff`` from
    the per-context-token decode time (one token's KV bytes), and the
    bandwidth share that ``decode_base`` implies for one read of the
    weights.  None where the constant is 0 (the fit clamped it)."""
    def ratio(num: float, den: float) -> Optional[float]:
        return num / den if den > 0 else None
    n_active = cfg.param_count(active_only=True)
    return {
        "prefill_eff": ratio(2.0 * n_active,
                             hw.flops * constants["prefill_per_token"]),
        "decode_bw_eff": ratio(cfg.kv_bytes_per_token(2),
                               hw.hbm_bw * constants["decode_per_ctx_token"]),
        "decode_base_bw_eff": ratio(cfg.param_count() * 2,
                                    hw.hbm_bw * constants["decode_base"]),
    }


def constants_ok(constants: Dict[str, float]) -> bool:
    return all(math.isfinite(v) and v >= 0 for v in constants.values())


def run(backend: str = "fake", device: str = "cuda", seed: int = 0,
        out: Optional[str] = None) -> CalibrationReport:
    t0 = time.time()
    report = build_report(backend, device=device, seed=seed)
    dt = time.time() - t0
    print(f"\n== sim-to-real calibration ({backend} backend) ==")
    print(f"  samples: {report.n_prefill} prefill ops, "
          f"{report.n_decode} decode ops "
          f"({report.meta.get('finished')} requests finished)")
    if backend == "real":
        print(f"  {report.meta['arch']} {report.meta['dtype']} on "
              f"{report.meta['card'] or device}; fit "
              f"{json.dumps(report.meta['fit'])}; decode steps "
              f"{json.dumps(report.meta['decode_spread'])}")
    print("  per-op relative error (|pred - measured| / measured):")
    print(f"  {'':>10} {'unfitted':>10} {'fitted':>10}")
    for key in ("prefill_median", "prefill_p90", "decode_median",
                "decode_p90", "overall_median"):
        print(f"  {key:>16} {report.unfitted[key]:10.4f} "
              f"{report.fitted[key]:10.4f}")
    if backend == "fake":
        # the acceptance claim — measured constants must beat the
        # roofline model on its own replay (real rows are informational
        # here; chip_smoke.py's calibrate phase holds the card's run to it)
        assert (report.fitted["overall_median"]
                < report.unfitted["overall_median"]), (
            "fitted constants did not reduce median per-op error: "
            f"{report.fitted} vs {report.unfitted}")
    if out:
        report.save(out)
    print(f"calibration_{backend},{dt * 1e6:.1f},"
          f"median_err {report.unfitted['overall_median']:.3f}"
          f"->{report.fitted['overall_median']:.3f}")
    return report


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true",
                    help="measure the port's live engines on a wall clock "
                    "(non-deterministic)")
    ap.add_argument("--smoke", action="store_true",
                    help="accepted as the JAX bench's command line takes "
                    "it; the run is the same without it")
    ap.add_argument("--device", default="cuda",
                    help="device of the --real engines (default cuda; cpu "
                    "runs the tiny config)")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights and prompt tokens of the --real run")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="save the report as JSON (the runner's "
                    "calibration input)")
    args = ap.parse_args()
    run(backend="real" if args.real else "fake", device=args.device,
        seed=args.seed, out=args.out)
