"""The port's experiment stack against the JAX package on the CPU.

Runner: each golden grid function of ``repro_torch.simulator.runner``
reproduces its ``tests/golden/<name>.json`` (meta and cells) bit for bit,
and the traced ecoserve/bursty cell reproduces
``tests/golden/trace_attribution.json`` through the port's ``obs``.

Write-back: ``bench_calibration_torch.writeback_runner`` on the port's
fake report gives the JAX ``ExperimentRunner``'s rows for the same spec
and report, and a calibrated DistServe or MoonCake cell fails with the
same error in both packages (their KV links read ``cost.hw``, which a
fitted executor lacks).

Flight recorder: a traced fake-backend ``PaDGServer`` run of trace-excerpt
requests on a ``VirtualClock`` gives the JAX server's events, through
``write_jsonl`` and back, and ``python -m repro_torch.obs`` reads it; on a
``WallClock`` the TTFT attribution stays exact while the interference
score has no stretch to measure (every gap between two slots breaks the
chain).

Runner grids run in spawned workers (``n_workers=2``), so no simulated
instance joins this process's actor registries; the servers here are
shut down, and every test leaves the port's registry at the size it
found.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_calibration_torch as port_bench  # noqa: E402
from benchmarks.bench_trace import GOLDEN_ROWS, smoke_spec  # noqa: E402
from repro.obs.events import Tracer as JaxTracer  # noqa: E402
from repro.serving.padg_server import PaDGServer as JaxServer  # noqa: E402
from repro.serving.replay import SlotConfig as JaxSlotConfig  # noqa: E402
from repro.serving.replay import VirtualClock as JaxVirtualClock  # noqa: E402
from repro.simulator.cost_model import FittedExecutor as JaxFitted  # noqa: E402
from repro.simulator.runner import ExperimentRunner as JaxRunner  # noqa: E402
from repro_torch.core import mitosis as port_mitosis  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.obs.events import Tracer  # noqa: E402
from repro_torch.obs.export import read_jsonl, write_jsonl  # noqa: E402
from repro_torch.obs.metrics import (attribution, interference,  # noqa: E402
                                     summarize)
from repro_torch.serving.padg_server import PaDGServer  # noqa: E402
from repro_torch.serving.replay import (SlotConfig, VirtualClock,  # noqa: E402
                                        WallClock, requests_from_trace)
from repro_torch.simulator import runner as port_runner  # noqa: E402
from repro_torch.simulator.cost_model import FittedExecutor  # noqa: E402
from repro_torch.traces import load_fixture, normalize_rate  # noqa: E402

GOLDEN = ROOT / "tests" / "golden"
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

# golden file -> the port's function that builds its grid
GRIDS = {"scenario_grid": "regression_runner",
         "goodput_frontier": "goodput_runner",
         "tenant_grid": "tenant_runner",
         "dynamic_scaling": "dynamic_scaling_runner",
         "fault_scenarios": "fault_runner",
         "interconnect_sensitivity": "interconnect_runner",
         "fleet_grid": "fleet_grid_runner",
         "static_scaling": "static_scaling_runner"}


@pytest.fixture(autouse=True)
def registry_unchanged():
    """Each test leaves the port's actor registry at the size it found.
    (The JAX registry is not held so: reference tests on the same worker
    leave entries in it, which a JAX server here replaces by iid and its
    shutdown then drops.)"""
    before = port_mitosis.registry_size()
    yield
    assert port_mitosis.registry_size() == before


def _dumps(x) -> str:
    return json.dumps(x, sort_keys=True)


# --------------------------------------------------------------------- #
# (i) the golden grids
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_port_runner_reproduces_golden_grid(name):
    golden = json.loads((GOLDEN / f"{name}.json").read_text())
    fresh = getattr(port_runner, GRIDS[name])(n_workers=2).run()
    assert not fresh.get("errors"), fresh.get("errors")
    assert fresh["meta"] == golden["meta"]
    assert _dumps(fresh["cells"]) == _dumps(golden["cells"])


# --------------------------------------------------------------------- #
# (ii) the traced cell's attribution golden
# --------------------------------------------------------------------- #
def _round(x, nd=9):
    if isinstance(x, float):
        return round(x, nd)
    if isinstance(x, dict):
        return {k: _round(v, nd) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_round(v, nd) for v in x]
    return x


def golden_payload(events, spec: dict) -> dict:
    """``benchmarks.bench_trace.golden_payload`` through the port's
    ``obs``: cell identity, event counts, attribution totals and leading
    rows, interference and TPOT digest."""
    attr = attribution(events)
    exact = all(
        r["queue_wait"] + r["prefill_wait"] + r["prefill_service"]
        + r["transfer"] == r["ttft"] for r in attr["rows"])
    digest = summarize(events)
    return {
        "cell": {k: spec[k] for k in (
            "strategy", "scenario", "rate", "seed", "duration", "warmup",
            "model", "hw", "tp", "pp", "n_instances", "workload")},
        "events": digest["by_type"],
        "attribution": {
            "exact": exact,
            "n": attr["totals"]["n"],
            "unattributed": attr["unattributed"],
            "totals": _round(attr["totals"]),
            "rows": _round(attr["rows"][:GOLDEN_ROWS])},
        "interference": _round(interference(events)),
        "tpot": _round(digest["tpot"]),
    }


def test_traced_cell_reproduces_attribution_golden(tmp_path):
    base = port_runner.regression_runner(n_workers=2)
    runner = port_runner.ExperimentRunner(
        strategies=("ecoserve",), scenarios=("poisson", "bursty"),
        rates=base.rates, model=base.model, hw=base.hw, tp=base.tp,
        pp=base.pp, n_instances=base.n_instances, workload=base.workload,
        duration=base.duration, warmup=base.warmup,
        base_seed=base.base_seed, n_workers=2, trace=str(tmp_path))
    results = runner.run()
    assert not results.get("errors"), results.get("errors")
    cell = next(c for c in results["cells"] if c["scenario"] == "bursty")
    assert cell["seed"] == smoke_spec()["seed"]
    events, _ = read_jsonl(cell["trace"])
    payload = golden_payload(events, cell)
    golden = json.loads((GOLDEN / "trace_attribution.json").read_text())
    assert _dumps(payload) == _dumps(golden)


# --------------------------------------------------------------------- #
# (iii) the write-back grid
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def fake_report(tmp_path_factory):
    path = tmp_path_factory.mktemp("report") / "report.json"
    port_bench.build_report("fake").save(path)
    return str(path)


def _jax_twin(runner):
    return JaxRunner(**{f.name: getattr(runner, f.name)
                        for f in dataclasses.fields(runner)})


def test_writeback_rows_equal_jax_runner(fake_report):
    runner = port_bench.writeback_runner(fake_report, seed=0, n_workers=2)
    got = runner.run()
    want = _jax_twin(runner).run()
    assert not got.get("errors"), got.get("errors")
    assert len(got["cells"]) == 48
    assert got["meta"] == want["meta"]
    assert _dumps(got["cells"]) == _dumps(want["cells"])
    cells = got["cells"]
    assert {c["strategy"] for c in cells} == {"ecoserve", "vllm", "sarathi"}
    assert all(c["metrics"]["finished"] > 0 for c in cells)
    seeds = {}
    for c in cells:
        seeds.setdefault((c["strategy"], c["scenario"], c["rate"]),
                         set()).add(c["seed"])
    assert len(seeds) == 24 and all(len(s) == 1 for s in seeds.values())


def test_fudg_calibrated_cells_fail_alike(fake_report):
    runner = port_bench.writeback_runner(fake_report, seed=0, n_workers=2)
    runner = dataclasses.replace(runner, strategies=("distserve",
                                                     "mooncake"),
                                 scenarios=runner.scenarios[:1],
                                 rates=runner.rates[:1],
                                 calibration=(fake_report,))
    got = runner.run()
    want = _jax_twin(runner).run()
    errors = [c.get("error") for c in got["cells"]]
    assert errors == [c.get("error") for c in want["cells"]]
    assert errors == ["AttributeError: 'FittedExecutor' object has no "
                      "attribute 'hw'"] * 2


# --------------------------------------------------------------------- #
# (iv, v) a traced served run
# --------------------------------------------------------------------- #
B, S = 4, 160
SLO_SET = (0.5, 0.05)
EXECUTOR = dict(prefill_base=1e-3, prefill_per_token=1e-4, decode_base=5e-4,
                decode_per_seq=2e-4, decode_per_ctx_token=1e-6,
                kv_capacity=B * S)


def trace_requests():
    """``tests/test_sim_real_conformance.py``'s trace-excerpt requests."""
    records = []
    for name in ("azure", "burstgpt"):
        records.extend(normalize_rate(load_fixture(name), 12.0)[:15])
    return requests_from_trace(records, max_prompt=S - 40, max_output=10,
                               seed=0)


def serve_port(clock) -> Tracer:
    trc = Tracer()
    with PaDGServer(None, n_instances=2, slo=SLO(*SLO_SET),
                    econf=SlotConfig(max_batch=B, max_seq_len=S),
                    backend="fake", executor=FittedExecutor(**EXECUTOR)
                    ) as server:
        stats = server.serve(trace_requests(), clock=clock, tracer=trc)
    assert len(stats.finished) == 30
    return trc


def test_served_trace_equals_jax_server(tmp_path):
    from repro.core.slo import SLO as JaxSLO
    from repro.obs.export import read_jsonl as jax_read
    from repro.obs.export import write_jsonl as jax_write
    from repro.serving.replay import requests_from_trace as jax_requests
    from repro.traces import load_fixture as jax_load
    from repro.traces import normalize_rate as jax_normalize

    path = tmp_path / "served.trace.jsonl"
    n = write_jsonl(serve_port(VirtualClock()), path)
    events, _ = read_jsonl(path)

    records = []
    for name in ("azure", "burstgpt"):
        records.extend(jax_normalize(jax_load(name), 12.0)[:15])
    jax_trc = JaxTracer()
    with JaxServer(None, n_instances=2, slo=JaxSLO(*SLO_SET),
                   econf=JaxSlotConfig(max_batch=B, max_seq_len=S),
                   backend="fake", executor=JaxFitted(**EXECUTOR)) as server:
        server.serve(jax_requests(records, max_prompt=S - 40, max_output=10,
                                  seed=0),
                     clock=JaxVirtualClock(), tracer=jax_trc)
    jax_path = tmp_path / "served_jax.trace.jsonl"
    assert n == jax_write(jax_trc, jax_path) > 0
    assert events == jax_read(jax_path)[0]
    assert path.read_bytes() == jax_path.read_bytes()

    out = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          "summarize", str(path)], cwd=ROOT, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    digest = json.loads(out.stdout)
    assert digest["attribution"] == {**digest["attribution"], "n": 30,
                                     "unattributed": 0, "exact": True}
    assert digest["interference"]["n"] > 0


def test_wall_clock_interference_is_not_measured():
    events = serve_port(WallClock(1.0)).events
    attr = attribution(events)
    assert attr["totals"]["n"] == 30 and attr["unattributed"] == 0
    assert all(r["queue_wait"] + r["prefill_wait"] + r["prefill_service"]
               + r["transfer"] == r["ttft"] for r in attr["rows"])
    assert interference(events) == {"score": 0.0, "p50": 0.0, "p99": 0.0,
                                    "max": 0.0, "n": 0}
    # the same requests on a virtual clock do give stretches
    assert interference(serve_port(VirtualClock()).events)["n"] > 0


# --------------------------------------------------------------------- #
# the example
# --------------------------------------------------------------------- #
def test_compare_strategies_example_prints_the_jax_table():
    args = ["--rate", "2", "--scenario", "poisson"]
    outs = [subprocess.run([sys.executable, str(ROOT / "examples" / script),
                            *args], cwd=ROOT, env=ENV, capture_output=True,
                           text=True, timeout=300)
            for script in ("compare_strategies.py",
                           "compare_strategies_torch.py")]
    for out in outs:
        assert out.returncode == 0, out.stderr
    assert outs[0].stdout.count("\n") >= 9
    assert outs[1].stdout == outs[0].stdout
