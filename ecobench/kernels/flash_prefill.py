"""``repro_torch.models.layers.flash_prefill_op``: one causal attention
prefill without a window.  A windowed call is left uncounted (no span):
its pairs are another count's.

A kernel file gives ``ATTR``, the ``repro_torch.models.layers`` entry it
wraps, and ``work(args, kwargs, step)``: the call's (flops, bytes) in
``harness/work.py``'s terms from the arguments' shapes, or None for a call
it does not count.  ``step`` is ``harness.trace.Step``, the decode step
under way.  ``harness.trace.Shims`` runs each counted call inside a
``ecobench.kernel.<file name>`` span; ``stats.kernel_roofline`` reads it.
"""
from ecobench.harness.work import flash_prefill_work

ATTR = "flash_prefill_op"


def work(args, kwargs, step):
    if kwargs.get("window", 0):
        return None
    q, k = args[0], args[1]
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    return flash_prefill_work(B, T, S, Hq, Hkv, D, q.element_size(),
                              kwargs.get("q_offset", 0))
