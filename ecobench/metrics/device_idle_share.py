"""1 - the union of device operations over the profiled sub-window (%)."""
from ecobench.harness import stats


def read(run):
    return stats.idle_share(run)
