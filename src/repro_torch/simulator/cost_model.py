"""Analytical (roofline) instance cost model for the cluster simulator.

Step durations are derived from the model config + hardware profile with
per-phase efficiency factors calibrated against the paper's own Table 3
measurements (Llama-30B prefill on an 8x L20 node: 6584.6 tok/s; on 8x
A800: 26189.2 tok/s — see tests/test_cost_model.py for the check).

The model is on the simulator's innermost loop (one ``decode_time`` call
per decode iteration per instance), so all config-derived quantities
(parameter counts, KV bytes/token, attention-layer count, roofline
denominators) are computed once per ``InstanceCostModel`` and memoized in
``_Consts``.  The memoized arithmetic keeps the exact floating-point
operation order of the original formulas — results are bit-identical, so
the golden regression grids do not move.

``decode_time``/``hybrid_time`` additionally accept a precomputed
effective-context *sum* (``ctx_sum``/``decode_ctx_sum``) so hot callers
(``Instance``) can skip building a per-iteration Python list; context
lengths are ints, so the summed fast path is exactly equal to the
per-element path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    flops: float               # peak bf16 FLOP/s per device
    hbm_bw: float              # bytes/s per device
    hbm_bytes: float           # capacity per device
    intra_node_bw: float       # bytes/s per device for intra-node traffic
    inter_node_bw: float       # bytes/s per NODE (NIC)
    devices_per_node: int
    prefill_eff: float         # achieved fraction of peak in prefill
    decode_bw_eff: float       # achieved fraction of HBM bw in decode
    comm_latency: float = 30e-6   # per collective hop


# L20: 119.5 TF bf16 peak, 864 GB/s GDDR6, PCIe4 x16 (~25 GB/s eff),
# 10 Gb Ethernet per node.  Efficiency calibrated to Table 3.
GPU_L20 = HardwareProfile(
    name="L20", flops=119.5e12, hbm_bw=864e9, hbm_bytes=48e9,
    intra_node_bw=25e9, inter_node_bw=10e9 / 8, devices_per_node=8,
    prefill_eff=0.47, decode_bw_eff=0.75)

# A800: 312 TF bf16, 2039 GB/s HBM2e, NVLink absent in paper's PCIe setup,
# 25 Gb RoCE per node.
GPU_A800 = HardwareProfile(
    name="A800", flops=312e12, hbm_bw=2039e9, hbm_bytes=80e9,
    intra_node_bw=25e9, inter_node_bw=25e9 / 8, devices_per_node=8,
    prefill_eff=0.60, decode_bw_eff=0.75)

# TPU v5e (the build target): ICI intra-pod, slow DCN across pods.
TPU_V5E_SIM = HardwareProfile(
    name="tpu-v5e", flops=197e12, hbm_bw=819e9, hbm_bytes=16e9,
    intra_node_bw=50e9, inter_node_bw=25e9 / 8, devices_per_node=256,
    prefill_eff=0.55, decode_bw_eff=0.80)


@dataclasses.dataclass(frozen=True)
class _Consts:
    """Per-(cfg, hw, tp, pp) constants hoisted out of the hot path."""
    n_active: int              # active parameters (MoE: top-k experts)
    param_bytes: int
    kv_per_tok: int
    attn_layers: int
    sliding_window: int
    prefill_flops_denom: float   # hw.flops * tp * prefill_eff
    decode_flops_denom: float    # hw.flops * tp * 0.35
    mem_denom: float             # hw.hbm_bw * decode_bw_eff


@dataclasses.dataclass(frozen=True)
class InstanceCostModel:
    """Cost model for ONE serving instance = `tp` x `pp` devices."""
    cfg: ModelConfig
    hw: HardwareProfile
    tp: int = 1
    pp: int = 1
    dtype_bytes: int = 2

    # ------------------------------------------------------------------ #
    @property
    def devices(self) -> int:
        return self.tp * self.pp

    @property
    def _c(self) -> _Consts:
        # memoized via the instance __dict__ (frozen dataclass: direct
        # dict insertion sidesteps the generated __setattr__)
        c = self.__dict__.get("_consts")
        if c is None:
            cfg, hw = self.cfg, self.hw
            c = _Consts(
                n_active=cfg.param_count(active_only=True),
                param_bytes=cfg.param_count() * self.dtype_bytes,
                kv_per_tok=cfg.kv_bytes_per_token(self.dtype_bytes),
                attn_layers=sum(1 for k in cfg.block_kinds()
                                if k in ("attn", "local")),
                sliding_window=cfg.sliding_window,
                prefill_flops_denom=hw.flops * self.tp * hw.prefill_eff,
                decode_flops_denom=hw.flops * self.tp * 0.35,
                mem_denom=hw.hbm_bw * hw.decode_bw_eff,
            )
            self.__dict__["_consts"] = c
        return c

    @property
    def param_bytes(self) -> int:
        return self._c.param_bytes

    @property
    def ctx_clamp(self) -> int:
        """Per-sequence context clamp for decode KV reads (0 = unbounded).
        Callers maintaining an incremental context sum must clamp each
        sequence at this value for ``ctx_sum`` fast paths to stay exact."""
        return self._c.sliding_window

    def kv_capacity_tokens(self) -> int:
        """Tokens of KV cache that fit after weights (10% activation slack)."""
        per_tok = self._c.kv_per_tok
        if per_tok == 0:                       # attention-free: effectively
            return 10_000_000                  # unbounded by KV memory
        free = (self.hw.hbm_bytes * self.devices * 0.9) - self.param_bytes
        return max(0, int(free / per_tok))

    # ------------------------------------------------------------------ #
    def _tp_comm_time(self, tokens: int) -> float:
        """Megatron TP: 2 all-reduce per layer over activations."""
        if self.tp == 1:
            return 0.0
        memo = self.__dict__.setdefault("_comm_memo", {})
        t = memo.get(tokens)
        if t is None:
            bytes_ar = tokens * self.cfg.d_model * self.dtype_bytes
            wire = 2.0 * bytes_ar * (self.tp - 1) / self.tp      # ring
            per_layer = wire / self.hw.intra_node_bw + self.hw.comm_latency
            t = 2 * self.cfg.num_layers * per_layer
            memo[tokens] = t
        return t

    def _pp_overhead(self, t_stage_total: float, microbatches: int) -> float:
        """Pipeline bubble: (pp-1)/m extra on top of the stage time."""
        if self.pp == 1:
            return 0.0
        return t_stage_total * (self.pp - 1) / max(1, microbatches)

    @staticmethod
    def _eff_ctx_sum(ctx_lens: List[int], sliding_window: int) -> int:
        if sliding_window:
            return sum(min(c, sliding_window) for c in ctx_lens)
        return sum(ctx_lens)

    # ------------------------------------------------------------------ #
    def prefill_time(self, prompt_lens: List[int],
                     kv_prefix_lens: Optional[List[int]] = None) -> float:
        """One prefill batch (PaDG/NoDG: full prompts; Sarathi passes
        chunks with kv_prefix_lens for the re-read of earlier chunks)."""
        if not prompt_lens:
            return 0.0
        c = self._c
        tokens = sum(prompt_lens)
        flops = 2.0 * c.n_active * tokens
        # attention: 2 matmuls of S^2 * H per head-dim-summed layer
        for i, s in enumerate(prompt_lens):
            ctx = s + (kv_prefix_lens[i] if kv_prefix_lens else 0)
            eff_ctx = min(ctx, c.sliding_window) if c.sliding_window else ctx
            flops += 4.0 * c.attn_layers * s * eff_ctx * self.cfg.d_model
        t_compute = flops / c.prefill_flops_denom
        # weight + kv-prefix reads
        bytes_moved = c.param_bytes / self.devices * min(
            1.0, tokens / 256.0)   # weight reads amortize over the batch
        if kv_prefix_lens:
            bytes_moved += sum(kv_prefix_lens) * c.kv_per_tok / self.devices
        t_mem = bytes_moved / c.mem_denom
        t = max(t_compute, t_mem) / self.pp + self._tp_comm_time(tokens)
        return t + self._pp_overhead(t, microbatches=len(prompt_lens))

    def decode_time(self, batch_size: int,
                    ctx_lens: Optional[List[int]] = None,
                    *, ctx_sum: Optional[int] = None) -> float:
        """One decode iteration for `batch_size` sequences.

        Accepts either the per-sequence context lengths (``ctx_lens``) or
        their precomputed effective sum (``ctx_sum``, already clamped at
        ``ctx_clamp``); integer context lengths make the two exactly equal.

        PP does NOT cut single-batch decode latency (Fig. 11's premise):
        the pp stages run sequentially for one iteration, so weights/KV
        stream through only a tp-wide memory system."""
        if batch_size == 0:
            return 0.0
        c = self._c
        flops = 2.0 * c.n_active * batch_size
        t_compute = flops / c.decode_flops_denom
        if ctx_sum is None:
            ctx_sum = self._eff_ctx_sum(ctx_lens, c.sliding_window)
        kv_bytes = c.kv_per_tok * ctx_sum
        bytes_moved = (c.param_bytes + kv_bytes) / self.tp
        t_mem = bytes_moved / c.mem_denom
        t = max(t_compute, t_mem) + self._tp_comm_time(batch_size)
        # pp point-to-point hops (small activations)
        t += (self.pp - 1) * self.hw.comm_latency
        return t

    def hybrid_time(self, chunk_lens: List[int], prefix_lens: List[int],
                    decode_batch: int,
                    decode_ctxs: Optional[List[int]] = None,
                    *, decode_ctx_sum: Optional[int] = None) -> float:
        """Sarathi-style fused iteration: decode batch + prefill chunks.
        Compute and memory streams overlap; chunked prefill re-reads the
        KV prefix of earlier chunks (the paper's §2.4.1 criticism).
        ``decode_ctx_sum`` is the clamped-context fast path, as in
        ``decode_time``."""
        c = self._c
        flops = 2.0 * c.n_active * (sum(chunk_lens) + decode_batch)
        for s, p in zip(chunk_lens, prefix_lens):
            flops += 4.0 * c.attn_layers * s * (s + p) * self.cfg.d_model
        t_compute = flops / c.prefill_flops_denom

        if decode_ctx_sum is None:
            decode_ctx_sum = self._eff_ctx_sum(decode_ctxs, c.sliding_window)
        bytes_moved = c.param_bytes / self.devices
        bytes_moved += c.kv_per_tok * sum(prefix_lens) / self.devices
        bytes_moved += c.kv_per_tok * decode_ctx_sum / self.devices
        t_mem = bytes_moved * self.pp / c.mem_denom
        tokens = sum(chunk_lens) + decode_batch
        # hybrid iteration latency is decode-like: pp stages run
        # sequentially (t_compute above is already tp-width)
        t = max(t_compute, t_mem) + self._tp_comm_time(tokens)
        t += (self.pp - 1) * self.hw.comm_latency
        return t

    # ------------------------------------------------------------------ #
    def kv_transfer_bytes(self, prompt_len: int) -> int:
        """KV cache bytes leaving a FuDG prefill instance per request."""
        return prompt_len * self._c.kv_per_tok

    def predict_prefill(self, prompt_len: int) -> float:
        """Single-request prefill-duration predictor used by Algorithm 2
        (paper: profiled offline over sequence lengths).  Memoized per
        prompt length — Algorithm 1 probes every instance's pending queue
        with it at each slot boundary."""
        memo = self.__dict__.setdefault("_prefill_memo", {})
        t = memo.get(prompt_len)
        if t is None:
            t = self.prefill_time([prompt_len])
            memo[prompt_len] = t
        return t


# Serialized field order of ``FittedExecutor`` — module-level (a tuple
# class attribute on a frozen dataclass would become a field).
FITTED_CONSTANT_FIELDS = (
    "prefill_base", "prefill_per_token", "decode_base",
    "decode_per_seq", "decode_per_ctx_token",
    "kv_capacity", "kv_bytes_per_token", "ctx_clamp")


@dataclasses.dataclass(frozen=True)
class FittedExecutor:
    """Linear cost model with *measured* constants (sim-to-real write-back).

    Implements the full ``InstanceCostModel`` surface the scheduling stack
    uses — ``prefill_time``/``decode_time``/``hybrid_time``/
    ``predict_prefill``/``kv_capacity_tokens``/``kv_transfer_bytes``/
    ``ctx_clamp`` — but with flat per-token linear forms whose constants
    come from ``repro_torch.serving.calibration`` least-squares fits of live
    engine step timings, so simulator cells can replay with measured
    throughput instead of roofline estimates.  ``predict_prefill(n)`` is
    arithmetically identical to ``prefill_time([n])`` (no memo needed:
    both are one multiply-add), which the conformance suite relies on.
    """
    prefill_base: float = 0.0
    prefill_per_token: float = 1e-4
    decode_base: float = 0.0
    decode_per_seq: float = 1e-4
    decode_per_ctx_token: float = 0.0
    kv_capacity: int = 10_000_000
    kv_bytes_per_token: int = 0
    ctx_clamp: int = 0

    # ------------------------------------------------------------------ #
    def prefill_time(self, prompt_lens: List[int],
                     kv_prefix_lens: Optional[List[int]] = None) -> float:
        if not prompt_lens:
            return 0.0
        tokens = sum(prompt_lens)
        if kv_prefix_lens:
            tokens += sum(kv_prefix_lens)
        return self.prefill_base + self.prefill_per_token * tokens

    def predict_prefill(self, prompt_len: int) -> float:
        return self.prefill_base + self.prefill_per_token * prompt_len

    def decode_time(self, batch_size: int,
                    ctx_lens: Optional[List[int]] = None,
                    *, ctx_sum: Optional[int] = None) -> float:
        if batch_size == 0:
            return 0.0
        if ctx_sum is None:
            ctx_sum = InstanceCostModel._eff_ctx_sum(
                ctx_lens or [], self.ctx_clamp)
        return (self.decode_base + self.decode_per_seq * batch_size
                + self.decode_per_ctx_token * ctx_sum)

    def hybrid_time(self, chunk_lens: List[int], prefix_lens: List[int],
                    decode_batch: int,
                    decode_ctxs: Optional[List[int]] = None,
                    *, decode_ctx_sum: Optional[int] = None) -> float:
        t = self.prefill_time(chunk_lens, prefix_lens)
        if decode_batch:
            t += self.decode_time(decode_batch, decode_ctxs,
                                  ctx_sum=decode_ctx_sum)
        return t

    # ------------------------------------------------------------------ #
    def kv_capacity_tokens(self) -> int:
        return self.kv_capacity

    def kv_transfer_bytes(self, prompt_len: int) -> int:
        return prompt_len * self.kv_bytes_per_token

    # ------------------------------------------------------------------ #
    def to_json(self) -> dict:
        return {k: getattr(self, k) for k in FITTED_CONSTANT_FIELDS}

    @classmethod
    def from_json(cls, d: dict) -> "FittedExecutor":
        kw = {k: d[k] for k in FITTED_CONSTANT_FIELDS if k in d}
        return cls(**kw)

    @classmethod
    def from_constants(cls, consts: dict,
                       like: Optional[InstanceCostModel] = None
                       ) -> "FittedExecutor":
        """Build from fitted timing constants, inheriting the capacity /
        transfer geometry of an analytic model (``like``) so the fitted
        cell admits exactly as many requests as the analytic one."""
        kw = {k: consts[k] for k in FITTED_CONSTANT_FIELDS if k in consts}
        if like is not None:
            kw.setdefault("kv_capacity", like.kv_capacity_tokens())
            kw.setdefault("kv_bytes_per_token", like._c.kv_per_tok)
            kw.setdefault("ctx_clamp", like.ctx_clamp)
        return cls(**kw)
