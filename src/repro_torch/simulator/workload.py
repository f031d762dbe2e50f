"""Workload generators matching the paper's Table 4 length statistics.

Input/output lengths are lognormal fits to (mean, median); LongBench's
inputs have mean < median so they use a clipped normal.  Inputs truncate
at 4096 as in the paper.  Arrivals are Poisson at a fixed request rate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List

import numpy as np

from repro_torch.core.request import Request


def poisson_arrival_times(rng: np.random.Generator, rate: float,
                          duration: float) -> np.ndarray:
    """Homogeneous Poisson arrival times on [0, duration).

    Draws exponential gaps in chunks until the cumulative time crosses
    ``duration`` — a single pre-sized draw silently truncates arrivals at
    long horizons whenever the sampled gaps run short.
    """
    chunk = int(rate * duration * 1.5) + 16
    gaps = rng.exponential(1.0 / rate, size=chunk)
    times = np.cumsum(gaps)
    while times[-1] < duration:
        gaps = rng.exponential(1.0 / rate, size=chunk)
        times = np.concatenate([times, times[-1] + np.cumsum(gaps)])
    return times[times < duration]


def _lognormal_params(mean: float, median: float):
    mu = math.log(median)
    sigma2 = 2.0 * math.log(mean / median)
    return mu, math.sqrt(max(sigma2, 1e-4))


@dataclasses.dataclass(frozen=True)
class LengthDist:
    mean: float
    median: float
    max_len: int

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.mean <= self.median:   # longbench inputs
            x = rng.normal(self.mean, 0.15 * self.mean, size=n)
        else:
            mu, sigma = _lognormal_params(self.mean, self.median)
            x = rng.lognormal(mu, sigma, size=n)
        return np.clip(x, 1, self.max_len).astype(int)


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    name: str
    input_dist: LengthDist
    output_dist: LengthDist


# Table 4 statistics
WORKLOADS = {
    "alpaca": WorkloadProfile(
        "alpaca",
        LengthDist(mean=20.63, median=17.0, max_len=4096),
        LengthDist(mean=163.80, median=119.0, max_len=2048)),
    "sharegpt": WorkloadProfile(
        "sharegpt",
        LengthDist(mean=343.76, median=148.0, max_len=4096),
        LengthDist(mean=237.20, median=152.0, max_len=2048)),
    "longbench": WorkloadProfile(
        "longbench",
        LengthDist(mean=2686.89, median=2736.5, max_len=4096),
        LengthDist(mean=101.78, median=19.0, max_len=2048)),
}


class WorkloadGen:
    def __init__(self, profile: WorkloadProfile, rate: float,
                 seed: int = 0):
        self.profile = profile
        self.rate = rate
        self.rng = np.random.default_rng(seed)

    def generate(self, duration: float) -> List[Request]:
        """Poisson arrivals over [0, duration)."""
        times = poisson_arrival_times(self.rng, self.rate, duration)
        n = len(times)
        ins = self.profile.input_dist.sample(self.rng, n)
        outs = self.profile.output_dist.sample(self.rng, n)
        return [
            Request(rid=i, arrival_time=float(times[i]),
                    prompt_len=int(ins[i]), output_len=int(outs[i]))
            for i in range(n)
        ]
