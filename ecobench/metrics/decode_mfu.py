"""Model FLOPs of the window's decode steps (at their occupied batch
and context) over their summed engine time at the chip's peak (%)."""
from ecobench.harness import stats


def read(run):
    return stats.share_of_peak(run, stats.decode_flops(run),
                               sum(dt for _, _, dt in run.decodes))
