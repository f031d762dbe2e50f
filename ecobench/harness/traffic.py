"""One generator for every traffic mix: ``traffic/<name>.json`` holds the
parameters, this module turns them into requests.

A window is one schedule, the same for every seed, that the seed reorders
locally.  The schedule is drawn from the mix's ``schedule.seed``:

- arrivals, a Poisson process at the cell's rate taken given its count:
  n = round(rate x seconds) due times uniform on the window, sorted (the
  law of a Poisson process's arrivals once their number is known);
- lengths, the mid-quantiles (i + 0.5) / n of the mix's prompt and output
  distributions, each in a uniform order.

The run's ``--seed`` then permutes, within each run of ``schedule.block``
consecutive requests, the gaps between arrivals, the prompt lengths and
the output lengths (three permutations of their own), and draws the
prompts' token ids.  Block ends keep their due times, so a long output
moves by a few arrivals at most: the tokens a window can complete before
its close, which the order of long outputs against the close sets, are
the schedule's and not the seed's.  Without ``schedule`` the seed draws
the whole order (``block`` = n).

Distributions (``simulator/workload.py``'s Table-4 fits, copied):
``normal``  mean, sd = ``sd_frac`` x mean; ``lognormal`` from (mean, median):
mu = ln(median), sigma^2 = 2 ln(mean / median).  Each is clipped to
[``min``, ``max``] and rounded down to an integer.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np

_Z = NormalDist()
WARMUP_RID = 1 << 30          # warm-up requests' ids, apart from the window's


def quantile(dist: dict, u: float) -> float:
    """The ``u`` quantile of one length distribution of a traffic file."""
    kind = dist["dist"]
    if kind == "normal":
        return dist["mean"] * (1.0 + dist["sd_frac"] * _Z.inv_cdf(u))
    if kind == "lognormal":
        mu = math.log(dist["median"])
        sigma = math.sqrt(max(2.0 * math.log(dist["mean"] / dist["median"]),
                              1e-4))
        return math.exp(mu + sigma * _Z.inv_cdf(u))
    raise ValueError(f"unknown length distribution {kind!r}")


def lengths(dist: dict, n: int) -> np.ndarray:
    """n lengths at the mid-quantiles, clipped and floored, ascending."""
    x = [quantile(dist, (i + 0.5) / n) for i in range(n)]
    return np.clip(np.floor(x), dist["min"], dist["max"]).astype(np.int64)


@dataclasses.dataclass
class Arrival:
    """One request of the window, before it is handed to the server."""
    rid: int
    arrival_time: float
    prompt_len: int
    output_len: int
    prompt_tokens: List[int]


def arrival_times(rate: float, seconds: float,
                  rng: np.random.Generator) -> np.ndarray:
    """round(rate x seconds) due times of a Poisson process at ``rate`` on
    [0, seconds), given their count: uniform draws, sorted."""
    n = max(1, int(round(rate * seconds)))
    return np.sort(rng.uniform(0.0, seconds, n))


def local_order(n: int, block: int, rng: np.random.Generator) -> np.ndarray:
    """A permutation of range(n) that shuffles each run of ``block``
    consecutive indices among themselves."""
    idx = np.arange(n)
    for s in range(0, n, block):
        idx[s:s + block] = s + rng.permutation(min(block, n - s))
    return idx


def window(mix: dict, rate: float, seconds: float, seed: int,
           vocab: int, first_rid: int = 0) -> List[Arrival]:
    """The requests due in [0, seconds) at ``rate`` requests a second.
    Token ids are drawn from [``token_lo``, vocab), so no prompt holds the
    ids a tokenizer reserves below it."""
    sched = mix.get("schedule", {})
    base = np.random.default_rng([int(sched.get("seed", seed)), 0x5c4ed])
    t = arrival_times(rate, seconds, base)
    n = len(t)
    p = lengths(mix["prompt"], n)[base.permutation(n)]
    o = lengths(mix["output"], n)[base.permutation(n)]
    rng = np.random.default_rng([seed, 0x7aff1c])
    block = int(sched.get("block", n))
    t = np.cumsum(np.diff(t, prepend=0.0)[local_order(n, block, rng)])
    p = p[local_order(n, block, rng)]
    o = o[local_order(n, block, rng)]
    lo = int(mix.get("token_lo", 3))
    out = []
    for i in range(n):
        ids = rng.integers(lo, vocab, size=int(p[i])).tolist()
        out.append(Arrival(first_rid + i, float(t[i]), int(p[i]), int(o[i]),
                           ids))
    return out


def warmup(mix: dict, seed: int, vocab: int, n: int) -> List[Arrival]:
    """``n`` requests due at once, at the mix's prompt quantiles spread over
    its range, the last at its longest prompt, each asking
    ``warmup_output`` tokens: they land the executors' gains on measured
    values and run each path, at the largest prefill the window can send,
    once before the window."""
    rng = np.random.default_rng([seed, 0x3a2b])
    us = [(i + 0.5) / n for i in range(n)]
    lo = int(mix.get("token_lo", 3))
    olen = int(mix.get("warmup_output", 8))
    out = []
    for i, u in enumerate(us):
        plen = int(np.clip(math.floor(quantile(mix["prompt"], u)),
                           mix["prompt"]["min"], mix["prompt"]["max"]))
        if i == n - 1:
            plen = int(mix["prompt"]["max"])
        out.append(Arrival(WARMUP_RID + i, 0.0, plen, olen,
                           rng.integers(lo, vocab, size=plen).tolist()))
    return out
