"""The traffic generator: Table-4 statistics, one schedule of sizes and
arrivals for every seed in a local order of its own, Poisson arrivals,
determinism by seed."""
import json
import math
import statistics

import numpy as np
import pytest

from ecobench_testlib import REPO
from ecobench.harness import traffic


def _mix(name):
    return json.loads((REPO / "ecobench" / "traffic" / f"{name}.json")
                      .read_text())


# ShareGPT's Table-4 fits (``simulator/workload.py``), as a traffic file
# would hold them
SHAREGPT = {"prompt": {"dist": "lognormal", "mean": 343.76, "median": 148.0,
                       "min": 1, "max": 4096},
            "output": {"dist": "lognormal", "mean": 237.2, "median": 152.0,
                       "min": 1, "max": 2048},
            "token_lo": 3}


def _clipped_lognormal_mean(mean, median, cap):
    """E[min(X, cap)] for the lognormal of this mean and median."""
    mu, s2 = math.log(median), 2 * math.log(mean / median)
    s = math.sqrt(s2)
    z = (math.log(cap) - mu) / s
    phi = statistics.NormalDist().cdf
    return mean * phi(z - s) + cap * (1 - phi(z))


@pytest.mark.parametrize("name,part,mean,median", [
    ("longbench", "prompt", 2686.89, None),
    ("longbench", "output", 101.78, 19.0),
    ("sharegpt", "prompt", 343.76, 148.0),
    ("sharegpt", "output", 237.20, 152.0),
])
def test_table4_statistics(name, part, mean, median):
    d = (SHAREGPT if name == "sharegpt" else _mix(name))[part]
    x = traffic.lengths(d, 20000)
    if median is not None:
        assert abs(statistics.median(x) - median) <= 1.0
        assert abs(_clipped_lognormal_mean(mean, median, d["max"])
                   - x.mean()) / x.mean() < 0.03
    else:
        assert abs(x.mean() - mean) / mean < 0.01
    assert x.min() >= d["min"] and x.max() <= d["max"]


def test_longbench_prompt_spread():
    x = traffic.lengths(_mix("longbench")["prompt"], 20000)
    assert abs(x.std() / 2686.89 - 0.15) < 0.01


def test_arrivals_are_poisson_given_their_count():
    """Over a long window the gaps are exponential (coefficient of
    variation 1) and the counts a second have their mean as variance:
    the bursts of a Poisson process, not a smoothed stream."""
    mix = _mix("longbench")
    rate, seconds = 4.0, 4000.0
    t = np.array([r.arrival_time for r in
                  traffic.window(mix, rate, seconds, 2**31 + 5, 100)])
    assert len(t) == round(rate * seconds)
    g = np.diff(t)
    assert abs(g.mean() - 1 / rate) < 0.01
    assert abs(g.std() / g.mean() - 1.0) < 0.05
    assert abs(np.median(g) - math.log(2) / rate) < 0.01
    counts = np.bincount(t.astype(int), minlength=int(seconds))
    assert abs(counts.var() / counts.mean() - 1.0) < 0.1


def test_same_sizes_every_seed_other_order():
    mix = _mix("longbench")
    a = traffic.window(mix, 3.0, 40.0, 1, 1000)
    b = traffic.window(mix, 3.0, 40.0, 2**31 + 7, 1000)
    assert sorted(r.prompt_len for r in a) == sorted(r.prompt_len for r in b)
    assert [r.prompt_len for r in a] != [r.prompt_len for r in b]
    assert all(0 <= r.arrival_time < 40.0 for r in a + b)
    assert [r.arrival_time for r in a] != [r.arrival_time for r in b]


def test_schedule_is_the_seeds_in_local_order():
    """Every seed gets the schedule's blocks: the same due time at each
    block's end and the same lengths in each block, in an order of its
    own; without a schedule the seed draws the whole window."""
    mix = _mix("longbench")
    block = mix["schedule"]["block"]
    a = traffic.window(mix, 2.8, 51.0, 3, 1000)
    b = traffic.window(mix, 2.8, 51.0, 2**31 + 11, 1000)
    assert len(a) == len(b) == 143
    for s in range(0, 143, block):
        x, y = a[s:s + block], b[s:s + block]
        assert x[-1].arrival_time == pytest.approx(y[-1].arrival_time)
        for f in ("prompt_len", "output_len"):
            assert (sorted(getattr(r, f) for r in x)
                    == sorted(getattr(r, f) for r in y))
    assert [r.output_len for r in a] != [r.output_len for r in b]
    free = {k: v for k, v in mix.items() if k != "schedule"}
    c = traffic.window(free, 2.8, 51.0, 3, 1000)
    d = traffic.window(free, 2.8, 51.0, 4, 1000)
    assert c[-1].arrival_time != d[-1].arrival_time
    assert (sorted(r.output_len for r in c)
            == sorted(r.output_len for r in d))


def test_deterministic_by_seed():
    mix = SHAREGPT
    a = traffic.window(mix, 5.0, 10.0, 99, 500)
    b = traffic.window(mix, 5.0, 10.0, 99, 500)
    assert [(r.arrival_time, r.prompt_len, r.output_len, r.prompt_tokens)
            for r in a] == [(r.arrival_time, r.prompt_len, r.output_len,
                             r.prompt_tokens) for r in b]
    assert all(3 <= t < 500 for r in a for t in r.prompt_tokens)


def test_window_holds_the_rate():
    mix = _mix("longbench")
    for seed in (5, 2**31 + 9):
        reqs = traffic.window(mix, 3.2, 40.0, seed, 100)
        assert len(reqs) == 128
        t = [r.arrival_time for r in reqs]
        assert t == sorted(t)


def test_warmup_reaches_the_top_of_the_prompts():
    mix = _mix("longbench")
    w = traffic.warmup(mix, 3, 100, 4)
    assert len(w) == 4 and max(r.prompt_len for r in w) == 4096
    assert all(r.rid >= traffic.WARMUP_RID for r in w)
