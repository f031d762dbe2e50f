"""Bound of the traced attention-prefill calls over the device time of
the kernels they launched (%)."""
from ecobench.harness import stats


def read(run):
    return stats.kernel_roofline(run, "flash_prefill")
