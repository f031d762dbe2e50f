"""Output tokens generated before the close over the window's seconds."""
from ecobench.harness import stats


def read(run):
    return stats.output_tokens(run) / run.window_s
