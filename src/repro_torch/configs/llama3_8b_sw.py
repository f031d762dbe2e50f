"""Llama-3-8B sliding-window VARIANT (beyond-assignment, long_500k only).

Identical to llama3-8b but every block uses a 8192-token sliding window so
the 524k-context decode shape is sub-quadratic.  This is the documented
extra variant from DESIGN.md; the faithful ``llama3-8b`` config is
unchanged.
"""
import dataclasses

from repro_torch.configs.base import LOCAL_ATTN
from repro_torch.configs.llama3_8b import CONFIG as _BASE

CONFIG = dataclasses.replace(
    _BASE,
    name="llama3-8b-sw",
    block_pattern=(LOCAL_ATTN,),
    sliding_window=8192,
)
