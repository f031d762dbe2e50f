"""Work counts and the chip's peaks: the yardstick of every MFU and
roofline share.

Model FLOPs count the products a token needs (2 per multiply-add of
every projection and of the SwiGLU), attention as 4 D per (query, key)
pair and query head (q.k and p.v), and the head on the rows whose logits
are read (the prefill's last one, each decoding sequence's).  A kernel's
bound is the larger of its operations over the peak rate and its bytes
over the HBM rate, bytes counted as inputs once and outputs once
(``chip_smoke.bound``'s rule, copied).
"""
from __future__ import annotations

from ecobench.harness.model import Model

# NVIDIA H100 SXM data sheet: dense bfloat16 tensor-core rate, float32 off
# the tensor cores, HBM3 rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def causal_pairs(T: int) -> int:
    """(query, key) pairs a causal mask leaves open over T positions."""
    return T * (T + 1) // 2


def prefill_flops(m: Model, T: int) -> float:
    """One prompt of T tokens through the model, the head on its last."""
    return (2.0 * m.layer_matmul_params() * T * m.layers
            + 4.0 * m.head_dim * m.heads * causal_pairs(T) * m.layers
            + 2.0 * m.d_model * m.vocab)


def decode_flops(m: Model, batch: int, ctx_sum: int) -> float:
    """One decode step of ``batch`` sequences holding ``ctx_sum`` cached
    tokens in all: each new token attends over its context and itself."""
    return (2.0 * m.layer_matmul_params() * batch * m.layers
            + 4.0 * m.head_dim * m.heads * (ctx_sum + batch) * m.layers
            + 2.0 * m.d_model * m.vocab * batch)


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the chip could take: operations or bytes."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def flash_prefill_work(B: int, T: int, S: int, Hq: int, Hkv: int, D: int,
                       es: int, q_offset: int = 0) -> tuple:
    """(flops, bytes) of one causal attention-prefill call without a window
    (query i at position q_offset + i sees keys 0 .. that position): q, k,
    v read once, o written once."""
    if S < q_offset + T:
        raise ValueError("queries past the last key")
    pairs = T * q_offset + causal_pairs(T)
    flops = 4.0 * D * Hq * B * pairs
    nbytes = es * B * (2 * T * Hq * D + 2 * S * Hkv * D)
    return flops, nbytes


def decode_attention_work(B: int, Hq: int, Hkv: int, D: int,
                          valid_rows: int, es: int) -> tuple:
    """(flops, bytes) of one decode-attention call: ``valid_rows`` K/V rows
    over the batch read once, q read, o written."""
    flops = 4.0 * D * Hq * valid_rows
    nbytes = es * (2 * valid_rows * Hkv * D + 2 * B * Hq * D)
    return flops, nbytes
