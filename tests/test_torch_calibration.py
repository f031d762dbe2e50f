"""The port's calibration loop against the JAX package on the CPU.

Traces: the port's copies of the fixture excerpts are the same bytes, and
its ``load_fixture``, ``normalize_rate``, ``fixture_replay`` and
``requests_from_trace`` give the JAX package's records and requests.

Fake backend: ``bench_calibration_torch.build_report("fake")`` equals
``benchmarks.bench_calibration.build_report("fake")`` to the bit, and lies
within the bands of ``tests/golden/calibration_report.json``; a report
the port writes, loaded by the JAX ``ExperimentRunner``, gives the rows
of the same report written by the JAX package.

Real backend: the ``--real --device cpu`` flow through the port's engines
(the JAX bench's tiny config) records one prefill per request with its
clipped prompt length, decode batches that sum to the tokens generated
after the prefills, and fits finite, non-negative constants.
"""
import json
import math
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_calibration_torch as port_bench  # noqa: E402
from benchmarks import bench_calibration as jax_bench  # noqa: E402
from repro import traces as jax_traces  # noqa: E402
from repro.serving.replay import requests_from_trace as jax_requests  # noqa: E402,E501
from repro_torch import traces as port_traces  # noqa: E402
from repro_torch.serving.calibration import (CalibrationRecorder,  # noqa: E402
                                             fit_constants)
from repro_torch.serving.engine import H100_SXM  # noqa: E402

FIXTURES = ("azure", "burstgpt")


def _request_fields(reqs):
    return [(r.rid, r.arrival_time, r.prompt_len, r.output_len, r.slo_class,
             r.prompt_tokens) for r in reqs]


# --------------------------------------------------------------------- #
# traces
# --------------------------------------------------------------------- #
def test_fixture_dir_lies_in_the_port():
    port_dir = pathlib.Path(port_traces.FIXTURE_DIR).resolve()
    assert port_dir == ROOT / "src" / "repro_torch" / "traces" / "fixtures"
    assert port_dir != pathlib.Path(jax_traces.FIXTURE_DIR).resolve()


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_csvs_are_byte_equal(name):
    fname, _ = port_traces.FIXTURES[name]
    assert ((port_traces.FIXTURE_DIR / fname).read_bytes()
            == (jax_traces.FIXTURE_DIR / fname).read_bytes())


@pytest.mark.parametrize("name", FIXTURES)
def test_load_fixture_matches(name):
    got = port_traces.load_fixture(name)
    assert got and got == jax_traces.load_fixture(name)


@pytest.mark.parametrize("rate", [port_bench.REAL_RATE,
                                  port_bench.FIXTURE_RATE])
@pytest.mark.parametrize("name", FIXTURES)
def test_normalize_rate_matches(name, rate):
    got = port_traces.normalize_rate(port_traces.load_fixture(name), rate)
    assert got == jax_traces.normalize_rate(jax_traces.load_fixture(name),
                                            rate)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_replay_matches(name):
    got = port_traces.fixture_replay(name, rate=4.0).generate()
    want = jax_traces.fixture_replay(name, rate=4.0).generate()
    assert got and _request_fields(got) == _request_fields(want)


@pytest.mark.parametrize("cell", ["fake", "real"])
def test_requests_from_trace_matches(cell):
    if cell == "fake":
        got = port_bench.trace_requests()
        want = jax_bench.trace_requests()
    else:
        got = port_bench.real_requests(vocab_size=300, seed=0)
        records = []
        for name in FIXTURES:
            records.extend(jax_traces.normalize_rate(
                jax_traces.load_fixture(name),
                port_bench.REAL_RATE)[:port_bench.REAL_PER_FIXTURE])
        want = jax_requests(
            records, max_prompt=port_bench.REAL_MAX_PROMPT,
            max_output=port_bench.REAL_MAX_OUTPUT, vocab_size=300, seed=0)
    assert len(got) == len(want) > 0
    assert _request_fields(got) == _request_fields(want)


# --------------------------------------------------------------------- #
# fake backend: the JAX bench's report to the bit
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def fake_reports():
    return (port_bench.build_report("fake"),
            jax_bench.build_report("fake"))


def test_fake_report_equals_jax(fake_reports):
    port, jax_report = fake_reports
    assert json.dumps(port.to_dict(), sort_keys=True) == json.dumps(
        jax_report.to_dict(), sort_keys=True)
    assert port.fitted["overall_median"] < port.unfitted["overall_median"]


def test_fake_report_within_golden_bands(fake_reports):
    """tests/test_sim_real_conformance.py's bands, on the port's report."""
    golden = json.loads(jax_bench.GOLDEN_PATH.read_text())
    fresh = fake_reports[0].to_dict()
    assert fresh["n_prefill"] == golden["n_prefill"]
    assert fresh["n_decode"] == golden["n_decode"]
    assert fresh["meta"] == golden["meta"]
    for side in ("unfitted", "fitted"):
        for key, want in golden[side].items():
            assert abs(fresh[side][key] - want) <= 0.02, (side, key)
    for key, want in golden["constants"].items():
        assert abs(fresh["constants"][key] - want) <= 0.02 * max(
            abs(want), 1e-12), key


def test_jax_runner_rows_from_port_report(fake_reports, tmp_path):
    """The JAX runner's calibrated cells give identical rows from the
    port's report file and from the JAX package's."""
    from repro.simulator.runner import ExperimentRunner

    port_path, jax_path = tmp_path / "port.json", tmp_path / "jax.json"
    fake_reports[0].save(port_path)
    fake_reports[1].save(jax_path)
    assert port_path.read_bytes() == jax_path.read_bytes()
    runner = ExperimentRunner(
        strategies=("ecoserve",), scenarios=("poisson",), rates=(4.0,),
        calibration=(str(port_path), str(jax_path)),
        model="llama-30b", hw="L20", tp=4, pp=1, n_instances=2,
        workload="sharegpt", duration=8.0, warmup=1.0,
        base_seed=42, n_workers=1)
    results = runner.run()
    assert not results.get("errors"), results.get("errors")
    rows = results["cells"]
    assert len(rows) == 2
    assert [r["calibration"] for r in rows] == [str(port_path),
                                                str(jax_path)]
    strip = [{k: v for k, v in r.items() if k != "calibration"}
             for r in rows]
    assert strip[0] == strip[1]
    assert strip[0]["metrics"]["finished"] > 0


# --------------------------------------------------------------------- #
# real backend on the CPU: the port's engines, the JAX bench's tiny config
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def cpu_run():
    return port_bench.serve_real("cpu", seed=0)


def test_real_cpu_serves_every_request(cpu_run):
    reqs, stats = cpu_run.requests, cpu_run.stats
    assert len(reqs) == 2 * port_bench.REAL_PER_FIXTURE
    assert len(stats.finished) == len(reqs) and not stats.rejected
    assert all(len(r.generated) == r.output_len for r in stats.finished)
    meta = cpu_run.meta
    assert (meta["backend"], meta["device"], meta["card"]) == ("real", "cpu",
                                                               None)
    assert meta["n_requests"] == meta["finished"] == len(reqs)


def test_real_cpu_prefill_samples(cpu_run):
    rec = cpu_run.recorder
    assert len(rec.prefill) == len(cpu_run.requests)
    assert sorted(t for t, _ in rec.prefill) == sorted(
        r.prompt_len for r in cpu_run.requests)
    assert max(r.prompt_len for r in cpu_run.requests) \
        <= port_bench.REAL_MAX_PROMPT
    assert all(dt > 0 for _, dt in rec.prefill)


def test_real_cpu_decode_samples(cpu_run):
    rec = cpu_run.recorder
    assert len(rec.decode) > 0
    assert sum(b for b, _, _ in rec.decode) == sum(
        len(r.generated) - 1 for r in cpu_run.stats.finished)
    assert all(1 <= b <= port_bench.REAL_MAX_BATCH
               for b, _, _ in rec.decode)
    spread = cpu_run.meta["decode_spread"]
    for side in spread.values():
        assert sum(n for n, *_ in side.values()) == len(rec.decode)
        assert all(0 < p10 <= p50 <= p90 for _, p10, p50, p90
                   in side.values())
    assert {int(b) for b in spread["batch"]} == {b for b, _, _ in rec.decode}
    assert spread["batch"]["8"][0] == sum(b == 8 for b, _, _ in rec.decode)


def test_real_cpu_report(cpu_run):
    report = cpu_run.report()
    assert report.n_prefill == len(cpu_run.requests)
    assert report.n_decode == len(cpu_run.recorder.decode) > 0
    assert port_bench.constants_ok(report.constants)
    assert cpu_run.meta["fit"] == {"prefill": "lstsq", "decode": "lstsq"}
    for side in (report.unfitted, report.fitted):
        assert all(math.isfinite(v) and v >= 0 for v in side.values())
    eff = port_bench.implied_efficiencies(
        report.constants, port_bench.real_config("cpu"), H100_SXM)
    assert set(eff) == {"prefill_eff", "decode_bw_eff",
                        "decode_base_bw_eff"}


# --------------------------------------------------------------------- #
def test_fit_forms_show_the_fallback_and_the_clamp():
    """One prefill length and a rank-deficient decode design take
    ``fit_constants``' median fallback, and ``fit_forms`` says so; on
    samples that fit it says ``lstsq``, and a coefficient whose fit goes
    negative is clamped to 0."""
    rec = CalibrationRecorder()
    for dt in (1e-3, 2e-3, 4e-3):
        rec.record_prefill(64, dt)
        rec.record_decode(2, 100, dt)
    assert port_bench.fit_forms(rec) == {"prefill": "median",
                                         "decode": "median"}
    consts = fit_constants(rec)
    assert consts["prefill_base"] == 0.0
    assert consts["prefill_per_token"] == pytest.approx(2e-3 / 64)
    assert consts["decode_per_ctx_token"] == 0.0

    rec = CalibrationRecorder()
    rng = np.random.default_rng(0)
    for i in range(8):
        rec.record_prefill(32 + 16 * i, 2e-2 - 1e-5 * (32 + 16 * i)
                           + 1e-4 * rng.random())
        batch, ctx = 1 + i % 4, int(rng.integers(50, 500))
        rec.record_decode(batch, ctx, 5e-3 - 2e-4 * batch + 1e-6 * ctx)
    assert port_bench.fit_forms(rec) == {"prefill": "lstsq",
                                         "decode": "lstsq"}
    consts = fit_constants(rec)
    assert consts["prefill_per_token"] == 0.0
    assert consts["decode_per_seq"] == 0.0
    assert consts["decode_base"] == pytest.approx(5e-3)
    assert consts["decode_per_ctx_token"] == pytest.approx(1e-6)
