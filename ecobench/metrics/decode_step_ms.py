"""Mean engine decode step (ms): the recorder hook's dt summed over
steps, over the steps."""
from ecobench.harness import stats


def read(run):
    return stats.mean_decode_ms(run)
