"""The end-to-end tails over every request of the window: a stall late in
the window has to show in them, not drop the stalled requests."""
import math
import types

import pytest

from ecobench_testlib import REPO  # noqa: F401  (puts the repo on the path)
from ecobench.harness import bench, stats

SLO = {"ttft_s": 15.0, "tpot_s": 0.1}


def _run(firsts, close=51.0):
    """A record of requests due once a second; ``firsts[i]`` is request
    i's first-token time, or None where it had none at the close."""
    reqs = [{"arrival": float(i), "first": f, "admitted": None}
            for i, f in enumerate(firsts)]
    return types.SimpleNamespace(requests=reqs, close=close, slo=SLO)


def test_stall_before_the_close_raises_the_tail():
    n = 51
    sound = _run([i + 0.2 for i in range(n)])
    # the server stalls from 40 s on: the last 11 requests get no first
    # token before the close, each having waited under the 15 s limit
    stalled = _run([i + 0.2 if i < 40 else None for i in range(n)])
    p90 = bench.load_reader("ttft_p90_s")
    p50 = bench.load_reader("ttft_p50_s")
    assert p90(sound) == pytest.approx(0.2)
    assert p90(stalled) > 5.0                  # 51 - 45: the close counts
    assert p50(stalled) >= p50(sound)
    assert len(stats.ttfts(stalled)) == n


def test_waiting_past_the_limit_is_infinite():
    run = _run([0.5, None, None], close=20.0)
    # due at 1 s: waited 19 s > 15 s; due at 2 s: 18 s > 15 s
    assert stats.ttfts(run) == [0.5, math.inf, math.inf]
    run = _run([0.5, None, None], close=10.0)
    assert stats.ttfts(run) == [0.5, 9.0, 8.0]


def test_suffixed_name_reads_through_its_base():
    run = _run([i + 0.25 for i in range(10)])
    assert bench.load_reader("ttft_p50_s.sat")(run) == \
        bench.load_reader("ttft_p50_s")(run)
    with pytest.raises(FileNotFoundError):
        bench.load_reader("no_such_metric.sat")
