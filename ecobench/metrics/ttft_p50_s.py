"""Median TTFT (s) from the due time over every request of the window;
one without a first token at the close counts to the close, or as
infinite once past the TTFT limit (``stats.ttfts``)."""
from ecobench.harness import stats


def read(run):
    return stats.nearest_rank(stats.ttfts(run), 50)
