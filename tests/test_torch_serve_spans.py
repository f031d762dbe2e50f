"""The served loop's own spans (``repro_torch.serving.spans``) on the CPU:
``run`` / ``wait`` / ``refuse`` tuples from a wall-clock serve over a
backend that sleeps a fixed time a slot, none on a ``VirtualClock``, the
profiler ranges beside them, their JSONL round trip, the constraint named
for each refusal, the engine's host seconds, and each instance's
decode-graph counts in the tracer's meta."""
import dataclasses
import json
import os
import random
import time

import pytest

torch = pytest.importorskip("torch")
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.constraints import check_constraints  # noqa: E402
from repro_torch.core.instance import InstanceStatus  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.obs.events import Tracer  # noqa: E402
from repro_torch.obs.export import read_jsonl, write_jsonl  # noqa: E402
from repro_torch.serving.engine import (EngineConfig,  # noqa: E402
                                        ServingEngine)
from repro_torch.serving.padg_server import PaDGServer  # noqa: E402
from repro_torch.serving.replay import (FakeEngine, SlotConfig,  # noqa: E402
                                        VirtualClock, WallClock)
from repro_torch.serving.spans import first_failed_constraint  # noqa: E402
from repro_torch.simulator.cost_model import FittedExecutor  # noqa: E402

SLOT_S = 0.02          # what the backend sleeps, and the modeled slot
NEW = ("run", "wait", "refuse")


class SleepingEngine(FakeEngine):
    """``FakeEngine`` whose every slot takes ``SLOT_S`` on the host."""

    def run_prefill(self, reqs):
        time.sleep(SLOT_S)
        return super().run_prefill(reqs)

    def run_decode(self, reqs):
        time.sleep(SLOT_S)
        return super().run_decode(reqs)


class CountingClock(WallClock):
    """``WallClock`` that counts the seconds it sleeps."""

    def __init__(self):
        super().__init__(1.0)
        self.slept = 0.0

    def sleep_until(self, t):
        p0 = time.perf_counter()
        super().sleep_until(t)
        self.slept += time.perf_counter() - p0


def serve(requests, clock, slo=SLO(ttft=5.0, tpot=0.5), n_instances=1):
    """A fake-backend serve whose executor models ``SLOT_S`` a slot."""
    trc = Tracer()
    ex = FittedExecutor(prefill_base=SLOT_S, prefill_per_token=0.0,
                        decode_base=SLOT_S, decode_per_seq=0.0,
                        kv_capacity=4 * 160)
    server = PaDGServer(None, n_instances, slo=slo,
                        econf=SlotConfig(max_batch=4, max_seq_len=160),
                        backend="fake", executor=ex)
    for inst in server.system.instances:
        inst.engine = SleepingEngine(server.econf)
    with server:
        stats = server.serve(requests, clock=clock, tracer=trc)
    return trc, stats


def one_request(output_len=40, arrival=0.05, rid=0, prompt_len=16):
    return Request(rid=rid, arrival_time=arrival, prompt_len=prompt_len,
                   output_len=output_len)


def of(events, etype):
    return [e for e in events if e[0] == etype]


def test_wall_clock_serve_runs_and_waits():
    clock = CountingClock()
    trc, stats = serve([one_request()], clock)
    assert len(stats.finished) == 1
    ev = trc.events
    slots, runs, waits = of(ev, "slot"), of(ev, "run"), of(ev, "wait")
    # one prefill and 39 decode steps: one run a slot, in order
    assert [(s[2], s[3]) for s in slots] == [(r[2], r[3]) for r in runs]
    assert [r[3] for r in runs] == ["prefill"] + ["decode"] * 39
    for s, r in zip(slots, runs):
        _, t, iid, kind, n, t_end, exec_s, host_s = r
        assert n == 1 and host_s is None and exec_s >= SLOT_S
        assert t_end == s[1] + s[4]           # the slot's modeled end
        assert t >= t_end                     # it ran after its sleep
    # the loop slept each slot's modeled length to its end, then ran it
    # (0.80 s of work takes about 1.62 s)
    slot_waits = [w for w in waits if w[3] == "slot"]
    assert [w[6] for w in slot_waits] == [r[5] for r in runs]
    assert all(w[2] >= w[6] - w[1] - 1e-3 for w in waits)
    assert sum(w[2] for w in slot_waits) == pytest.approx(
        sum(s[4] for s in slots), rel=0.05)
    assert [w[3] for w in waits if w[3] != "slot"] == ["arrival"]
    assert sum(w[2] for w in waits) == pytest.approx(clock.slept, abs=0.005)
    assert not of(ev, "refuse")
    origin = trc.meta["perf_counter_origin"]
    assert 0 < time.perf_counter() - origin < 10


def test_refusals_name_the_constraint_and_forced_waits():
    # a modeled prefill (SLOT_S) longer than the TTFT limit: both
    # instances refuse on arrival, and the queue's forced admission
    # (past 4 x ttft) takes the request after a forced wait
    reqs = [one_request(output_len=3, arrival=0.01 * i, rid=i)
            for i in range(2)]
    trc, stats = serve(reqs, CountingClock(), slo=SLO(ttft=0.01, tpot=0.5),
                       n_instances=2)
    assert len(stats.finished) == 2
    refuse = of(trc.events, "refuse")
    assert [r[2] for r in refuse] == [0, 1]
    assert [r[3] for r in refuse] == [[[0, "ttft"], [1, "ttft"]]] * 2
    assert "forced" in {w[3] for w in of(trc.events, "wait")}


def test_virtual_clock_adds_nothing():
    trc, stats = serve([one_request()], VirtualClock())
    assert len(stats.finished) == 1 and of(trc.events, "slot")
    assert not [e for e in trc.events if e[0] in NEW]
    assert "perf_counter_origin" not in trc.meta


def test_jsonl_round_trip_keeps_the_new_tuples(tmp_path):
    reqs = [one_request(output_len=3, arrival=0.01 * i, rid=i)
            for i in range(2)]
    trc, _ = serve(reqs, CountingClock(), slo=SLO(ttft=0.01, tpot=0.5))
    path = tmp_path / "spans.jsonl"
    write_jsonl(trc, path)
    events, meta = read_jsonl(path)
    new = [e for e in trc.events if e[0] in NEW]
    assert {e[0] for e in new} == set(NEW)
    assert [e for e in events if e[0] in NEW] == new
    assert meta["perf_counter_origin"] == trc.meta["perf_counter_origin"]


def test_profiler_ranges_match_the_tuples(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trc, _ = serve([one_request(output_len=8)], CountingClock())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                     if e.get("cat") == "user_annotation"
                     and e["name"].startswith(("repro_torch.run.",
                                               "repro_torch.wait."))),
                    key=lambda e: e["ts"])
    spans = [e for e in trc.events if e[0] in ("run", "wait")]
    assert [e["name"] for e in ranges] == [
        f"repro_torch.{s[0]}.{s[3]}" for s in spans]
    for e, s in zip(ranges, spans):
        secs = s[6] if s[0] == "run" else s[2]
        assert e["dur"] * 1e-6 == pytest.approx(secs, abs=1e-3)


def _status(rng):
    saved = [rng.uniform(0.0, 0.3) for _ in range(rng.randrange(4))]
    return InstanceStatus(
        iid=0, phase="decode",
        pending_prefill_lens=[rng.randrange(1, 400)
                              for _ in range(rng.randrange(3))],
        pending_prefill_tokens=0, num_decoding=len(saved),
        saved_tpots=saved, kv_tokens_used=rng.randrange(0, 900),
        kv_tokens_capacity=1000, last_switch_time=0.0,
        decode_iter_time_plus_one=rng.uniform(0.0, 0.12),
        decode_tpot_floor=rng.choice([0.1, float("inf")]))


def test_first_failed_constraint_agrees_with_check_constraints():
    rng = random.Random(20261018)
    predict = FittedExecutor(prefill_base=1e-3, prefill_per_token=4e-4
                             ).predict_prefill
    seen = set()
    for i in range(4000):
        st = _status(rng)
        req = Request(rid=i, arrival_time=rng.uniform(0.0, 1.0),
                      prompt_len=rng.randrange(1, 300), output_len=4)
        slo = SLO(ttft=rng.uniform(0.05, 0.6), tpot=0.1)
        now = rng.uniform(0.8, 1.2)
        kw = dict(conservative=rng.random() < 0.5,
                  expected_kv_tokens=rng.choice([None, rng.randrange(600)]))
        name = first_failed_constraint(st, req, slo, predict, now, **kw)
        assert (name is None) == check_constraints(st, req, slo, predict,
                                                   now, **kw)
        seen.add(name)
    assert seen == {None, "ttft", "tpot_slack", "tpot_batch", "kv"}


def test_engine_host_seconds():
    cfg = dataclasses.replace(
        get_smoke_config("llama3-8b"), num_layers=2, d_model=128,
        num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256, vocab_size=300)

    class Rec:
        def record_prefill(self, T, dt):
            self.dt = dt

        def record_decode(self, batch, ctx_sum, dt):
            self.dt = dt

    rec = Rec()
    eng = ServingEngine(cfg, econf=EngineConfig(max_batch=2, max_seq_len=64,
                                                eos_token=-1, device="cpu"),
                        recorder=rec)
    assert eng.host_s == 0.0
    eng.prefill(Request(rid=0, arrival_time=0.0, prompt_len=8, output_len=4,
                        prompt_tokens=list(range(2, 10))))
    assert 0 < eng.host_s <= rec.dt
    h = eng.host_s
    eng.decode_step()
    assert 0 < eng.host_s - h <= rec.dt


def test_decode_graph_counts_per_instance():
    trc, _ = serve([one_request(output_len=3)], CountingClock(),
                   n_instances=2)
    assert trc.meta["decode_graph"] == {0: None, 1: None}   # FakeEngine
    cfg = dataclasses.replace(
        get_smoke_config("qwen2-72b"), num_layers=2, d_model=128,
        num_heads=2, num_kv_heads=1, head_dim=64, d_ff=256, vocab_size=300)
    trc = Tracer()
    req = one_request(output_len=4, prompt_len=8)
    req.prompt_tokens = list(range(2, 10))
    with PaDGServer(cfg, 2, slo=SLO(ttft=5.0, tpot=0.5),
                    econf=EngineConfig(max_batch=2, max_seq_len=64,
                                       eos_token=-1),
                    backend="real", device="cpu") as server:
        stats = server.serve([req], clock=CountingClock(), tracer=trc)
    assert len(stats.finished) == 1 and len(req.generated) == 4
    # a CPU engine decodes eagerly: no capture, no replay
    assert trc.meta["decode_graph"] == {
        0: {"captures": 0, "steps": 0}, 1: {"captures": 0, "steps": 0}}
