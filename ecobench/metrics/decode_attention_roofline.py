"""Bound of the traced decode-attention calls (bytes of the valid K/V
rows, q and o) over the device time of the kernels they launched (%)."""
from ecobench.harness import stats


def read(run):
    return stats.kernel_roofline(run, "decode_attention")
