"""Model FLOPs of the window's prefills over their summed engine time
at the chip's peak (%)."""
from ecobench.harness import stats


def read(run):
    return stats.share_of_peak(run, stats.prefill_flops(run),
                               sum(dt for _, dt in run.prefills))
