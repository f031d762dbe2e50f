"""Real-execution serving engine: continuous batching over the port's
PyTorch model, on an NVIDIA GPU (or the CPU, when asked).

One ``ServingEngine`` is one PaDG *instance*: it owns params, a slotted
cache (KV rows for attention layers, a ring of window rows for
sliding-window ones, conv history and h for RG-LRU layers, shift and
state for RWKV-6 layers), and executes prefill/decode slots for the scheduling ``Instance`` it
is attached to.  Counterpart of ``repro.serving.engine`` with the surface
``RealEngineBackend`` uses: ``prefill(req)``, ``decode_step()``,
``free_slots()``, ``release()``, ``econf``, ``executor``, ``recorder``,
``slot_req`` and ``params``.  Durations are measured on the host clock
after the step's device-to-host read of its argmax, which waits for the
device, so the executor sees device time and not launch time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.request import Request
from repro_torch.models import (forward, init_cache, init_params,
                                 write_slot)
from repro_torch.simulator.cost_model import HardwareProfile

# H100 SXM datasheet figures (dense bf16 tensor-core peak, HBM3 rate and
# size); NVLink's 450 GB/s each way stands in for both links, which the
# engine's one-card executor (tp=1) never reads.  The two efficiencies are
# not fitted values.  chip_smoke.py's calibrate phase fits the cost model's
# constants on the card, and PERF.md's calibration record keeps them.  The
# engine's step times are host-clock and serving is host-bound, so the
# fitted decode terms hold host dispatch; an efficiency derived from them
# would charge HBM for host time.  The values stay as the roofline's, and
# MeasuredExecutor's gains track the gap while it serves.
H100_SXM = HardwareProfile(
    name="h100-sxm", flops=989e12, hbm_bw=3.35e12, hbm_bytes=80e9,
    intra_node_bw=450e9, inter_node_bw=450e9, devices_per_node=1,
    prefill_eff=0.5, decode_bw_eff=0.7)


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8            # decode slots
    max_seq_len: int = 256        # per-slot KV capacity
    dtype: object = torch.float32
    eos_token: int = 1
    greedy: bool = True
    device: str = "cuda"


class MeasuredExecutor:
    """ExecutorModel backed by observed wall-clock times, used by the
    scheduling Instance attached to a real engine.

    Shape-aware: predictions follow the same linear forms as
    ``simulator.cost_model`` (prefill base + per-token; decode per-slot
    base + ctx-sum term), with the constants seeded by probing a cost
    model (``seed_model``) and a single EWMA *gain* per op tracking the
    observed/predicted ratio — so a slot with twice the batch really is
    predicted to take longer, and the first prediction before any
    observation is the model's estimate rather than a magic number.
    """

    # no sliding-window clamp on the real engine's slotted KV: advertise
    # the Instance ctx_sum fast path with an unbounded clamp
    ctx_clamp = 0

    def __init__(self, seed_model=None,
                 fallback_prefill=2e-4, fallback_decode=5e-2):
        if seed_model is not None:
            p1 = seed_model.prefill_time([1])
            p257 = seed_model.prefill_time([257])
            self._prefill_per_tok = max((p257 - p1) / 256.0, 1e-12)
            self._prefill_base = max(p1 - self._prefill_per_tok, 0.0)
            d10 = seed_model.decode_time(1, [0])
            d20 = seed_model.decode_time(2, [0, 0])
            d1k = seed_model.decode_time(1, [1024])
            self._decode_per_seq = max(d20 - d10, 0.0)
            self._decode_per_ctx = max((d1k - d10) / 1024.0, 0.0)
            self._decode_base = max(d10 - self._decode_per_seq, 0.0)
        else:
            # legacy flat fallbacks (no model to probe)
            self._prefill_per_tok = fallback_prefill
            self._prefill_base = 0.0
            self._decode_per_seq = fallback_decode
            self._decode_per_ctx = 0.0
            self._decode_base = 0.0
        self._prefill_gain = 1.0
        self._decode_gain = 1.0

    def observe_prefill(self, tokens: int, dt: float) -> None:
        pred = self._prefill_base + self._prefill_per_tok * max(1, tokens)
        if pred > 0:
            self._prefill_gain = (0.7 * self._prefill_gain
                                  + 0.3 * dt / pred)

    def observe_decode(self, dt: float, batch: int = 1,
                       ctx_sum: int = 0) -> None:
        pred = (self._decode_base + self._decode_per_seq * max(1, batch)
                + self._decode_per_ctx * ctx_sum)
        if pred > 0:
            self._decode_gain = 0.7 * self._decode_gain + 0.3 * dt / pred

    def prefill_time(self, lens: List[int],
                     kv_prefix_lens: Optional[List[int]] = None) -> float:
        if not lens:
            return 0.0
        tokens = sum(lens) + (sum(kv_prefix_lens) if kv_prefix_lens else 0)
        return self._prefill_gain * (self._prefill_base
                                     + self._prefill_per_tok * tokens)

    def decode_time(self, batch: int, ctx_lens: Optional[List[int]] = None,
                    *, ctx_sum: Optional[int] = None) -> float:
        if batch == 0:
            return 0.0
        if ctx_sum is None:
            ctx_sum = sum(ctx_lens) if ctx_lens else 0
        return self._decode_gain * (self._decode_base
                                    + self._decode_per_seq * batch
                                    + self._decode_per_ctx * ctx_sum)


def resolve_device(device) -> torch.device:
    """The engine's device; a CUDA device must exist (no silent CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "EngineConfig.device is 'cuda' but no CUDA device is available; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev


class ServingEngine:
    """Slot-based continuous batching with a fixed-shape decode step over
    all ``max_batch`` slots."""

    def __init__(self, cfg: ModelConfig, params=None, seed: int = 0,
                 econf: EngineConfig = EngineConfig(),
                 cost_model=None, recorder=None):
        assert not cfg.is_encoder, "decode engine serves decoder models"
        if not econf.greedy:
            raise NotImplementedError(
                "the engine decodes greedily only; EngineConfig.greedy=False "
                "has no sampler behind it")
        self.cfg = cfg
        self.econf = econf
        self.device = resolve_device(econf.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, econf.dtype, self.device)
        self.params = params
        B, S = econf.max_batch, econf.max_seq_len
        self.cache = init_cache(cfg, B, S, econf.dtype, self.device)
        self.tokens = torch.zeros((B, 1), dtype=torch.long,
                                  device=self.device)
        self.lengths = np.zeros(B, np.int32)          # context per slot
        self.slot_req: List[Optional[Request]] = [None] * B
        if cost_model is None:
            from repro_torch.simulator.cost_model import InstanceCostModel
            cost_model = InstanceCostModel(cfg=cfg, hw=H100_SXM)
        self.executor = MeasuredExecutor(seed_model=cost_model)
        self.recorder = recorder      # optional CalibrationRecorder

    # --------------------------------------------------------------- #
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def prefill(self, req: Request) -> int:
        """Run the prompt through the model, land the request in a decode
        slot.  Returns the generated first token."""
        slots = self.free_slots()
        assert slots, "no free decode slot"
        slot = slots[0]
        prompt = req.prompt_tokens
        T = len(prompt)
        t0 = time.perf_counter()
        toks = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits, pcache = forward(self.params, self.cfg, {"tokens": toks},
                                 return_cache=True)
        # global k/v rows [:T] (decode masks out a previous request's rows
        # past T: it attends over min(len + 1, S)); the rest of the slot
        # whole (models.write_slot)
        write_slot(self.cache, pcache, slot, T)
        self.tokens[slot, 0] = logits[0, -1].argmax()
        first = int(self.tokens[slot, 0])        # waits for the device
        dt = time.perf_counter() - t0
        self.executor.observe_prefill(T, dt)
        if self.recorder is not None:
            self.recorder.record_prefill(T, dt)

        self.lengths[slot] = T
        self.slot_req[slot] = req
        req.generated = [first]
        return first

    def decode_step(self) -> Dict[int, int]:
        """One decode iteration over all slots (occupied or not: one fixed
        shape).  Returns {slot: token} for the occupied slots."""
        occupied = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not occupied:
            return {}
        t0 = time.perf_counter()
        lengths = torch.from_numpy(self.lengths).to(self.device)
        live = torch.from_numpy(np.array(
            [r is not None for r in self.slot_req])).to(self.device)
        logits, self.cache = forward(
            self.params, self.cfg, {"tokens": self.tokens},
            cache=self.cache, cache_len=lengths)
        # only the occupied slots take their new token, as in the
        # reference: a free slot decodes its stale token again, which a MoE
        # model routes beside the live ones (one capacity for the step)
        new = logits[:, 0].argmax(-1, keepdim=True)
        self.tokens = torch.where(live[:, None], new, self.tokens)
        new_tokens = new[:, 0].tolist()           # waits for the device
        dt = time.perf_counter() - t0
        ctx_sum = int(sum(self.lengths[i] for i in occupied))
        self.executor.observe_decode(dt, batch=len(occupied),
                                     ctx_sum=ctx_sum)
        if self.recorder is not None:
            self.recorder.record_decode(len(occupied), ctx_sum, dt)

        out: Dict[int, int] = {}
        for i in occupied:
            tok = new_tokens[i]
            self.lengths[i] += 1
            out[i] = tok
            req = self.slot_req[i]
            req.generated.append(tok)
            done = (tok == self.econf.eos_token
                    or len(req.generated) >= req.output_len
                    or self.lengths[i] >= self.econf.max_seq_len - 1)
            if done:
                self.slot_req[i] = None
                self.lengths[i] = 0
        return out

    def release(self, req: Request) -> None:
        """Free the slot holding ``req`` (scheduler-side early finish,
        e.g. a one-token request done at prefill)."""
        for i, r in enumerate(self.slot_req):
            if r is req:
                self.slot_req[i] = None
                self.lengths[i] = 0
                return
