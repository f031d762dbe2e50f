"""90th percentile of admission minus due time (s), the close standing
in for a request still queued."""
from ecobench.harness import stats


def read(run):
    return stats.nearest_rank(stats.queue_waits(run), 90)
