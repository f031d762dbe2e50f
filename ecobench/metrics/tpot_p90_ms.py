"""90th percentile over requests of the mean gap between output tokens
after the first decode token (ms), to the latest token where unfinished."""
from ecobench.harness import stats


def read(run):
    v = stats.nearest_rank(stats.tpots(run), 90)
    return None if v is None else 1e3 * v
