"""The program's own spans as the benchmark reads them: a traced run at a
CPU size through ``spans.py``, and the readers of ``harness/program.py``
on hand-made tuples and a hand-made chrome trace (µs) through its
reduction."""
import pytest

from ecobench_testlib import tiny
from ecobench.harness import program, trace
from test_ecobench_trace import X


def test_traced_cpu_run_reads_the_program_spans():
    import torch
    from ecobench import spans
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        row = spans.run("qwen2-72b.longbench", 2**31 + 23, 2.0, True,
                        rate=4.0, t_start=0.0, device="cpu", drain=True,
                        shrink=tiny(rate=4.0))
    finally:
        torch.set_num_threads(n)
    assert row["correct"] is True
    for k in ("slot_wait_share", "queued_arrival_share",
              "decode_host_share"):
        assert 0.0 <= row[k] <= 100.0, k
    assert row["decode_host_share"] > 0
    assert row["idle_in_decode_share"] is None       # no profiler here
    # the program's waits are the clock's sleeps; a decode run a step
    assert abs(row["wait_less_slept_share"]) < 1.0
    assert row["decode_runs_less_steps"] == 0
    assert row["decode_over_modeled"] > 0
    assert row["arrival_late_p90_s"] >= 0


def test_no_spans_read_nothing():
    assert program.slot_wait_share([], 10.0) is None
    assert program.queued_arrival_share([("arrive", 0.0, 1, "d", None)]) \
        is None
    assert program.decode_host_share([]) is None
    assert program.idle_in_decode_share(trace.reduce(
        [X("ecobench.window", "user_annotation", 0, 10)])) is None
    assert program.idle_in_decode_share(None) is None
    assert program.refusals([]) == {}
    assert program.decode_over_modeled([]) is None


EVENTS = [
    ("arrive", 0.0, 0, "default", None),
    ("arrive", 0.1, 1, "default", None),
    ("refuse", 0.1, 1, [[0, "ttft"], [1, "kv"]]),
    ("arrive", 0.2, 2, "default", None),
    ("arrive", 0.3, 3, "default", None),
    ("slot", 0.5, 0, "decode", 0.25, (0,), 0, 0, 0, 0, 1, 0, 4),
    ("wait", 0.5, 0.25, "slot", 0, "decode", 0.75),
    ("run", 0.75, 0, "decode", 1, 0.75, 0.5, 0.4),
    ("wait", 1.25, 0.5, "arrival", None, None, 1.75),
    ("run", 1.8, 0, "prefill", 1, 1.8, 0.3, 0.1),
    ("run", 2.1, 1, "decode", 1, None, 0.5, 0.5),
]


def test_readers_on_tuples():
    assert program.slot_wait_share(EVENTS, 5.0) == pytest.approx(5.0)
    assert program.queued_arrival_share(EVENTS) == pytest.approx(25.0)
    # decode runs only: (0.4 + 0.5) / (0.5 + 0.5)
    assert program.decode_host_share(EVENTS) == pytest.approx(90.0)
    assert program.refusals(EVENTS) == {"ttft/kv": 1}
    # the run with a modeled end pairs with its slot: 0.5 s for 0.25
    assert program.decode_over_modeled(EVENTS) == pytest.approx(2.0)


def test_idle_in_decode_share_from_a_trace():
    events = [
        X("ecobench.window", "user_annotation", 1000, 1000),
        # decode ranges 900-1300 (cut to 1000-1300) and 1600-1900
        X("repro_torch.run.decode", "user_annotation", 900, 400),
        X("repro_torch.run.prefill", "user_annotation", 1300, 300),
        X("repro_torch.run.decode", "user_annotation", 1600, 300),
        # device: 1000-1100 and 1050-1150 (one busy stretch), 1250-1400,
        # 1700-1750; a copy 1850-2100
        X("gemm", "kernel", 1000, 100, tid=7),
        X("gemm", "kernel", 1050, 100, tid=7),
        X("attn", "kernel", 1250, 150, tid=7),
        X("mul", "kernel", 1700, 50, tid=7),
        X("Memcpy DtoH", "gpu_memcpy", 1850, 250, tid=7),
    ]
    # idle in 1000-1300: 1150-1250 (100); in 1600-1900: 1600-1700 and
    # 1750-1850 (200); over the 1000 µs window
    assert program.idle_in_decode_share(trace.reduce(events)) == \
        pytest.approx(30.0)
