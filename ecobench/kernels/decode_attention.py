"""``repro_torch.models.layers.decode_attention_op``: one decode step's
attention over the slots' cached K/V.  Its rows are the ones the step's
``valid`` lengths hold, min(length + 1, S) a slot from the engine's host
lengths at the step's start (``step.valid_rows``): no read of the device.
(The kernel file's protocol: ``kernels/flash_prefill.py``.)
"""
from ecobench.harness.work import decode_attention_work

ATTR = "decode_attention_op"


def work(args, kwargs, step):
    q, k_cache = args[0], args[1]
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    return decode_attention_work(B, Hq, Hkv, D, step.valid_rows(S),
                                 q.element_size())
