"""Sim-to-real calibration: fit cost-model constants from engine timings.

The live engine (``repro_torch.serving.engine``) and the fake replay backend
(``repro_torch.serving.replay``) both report per-op step timings into a
``CalibrationRecorder``: prefill as (tokens, dt) pairs and decode as
(batch, ctx_sum, dt) triples.  ``fit_constants`` least-squares-fits the
same linear forms ``simulator.cost_model.FittedExecutor`` evaluates, and
``CalibrationReport`` compares an analytic model's predictions against
the measurements (per-op relative error, unfitted vs fitted) in a
JSON-safe shape pinned by ``tests/golden/calibration_report.json``.

Deliberately import-light: numpy + the cost model only, never jax — the
simulator runner's worker processes load fitted constants through
``load_fitted_executor`` and must not pay (or require) a jax import.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.events import NULL_TRACER
from repro_torch.simulator.cost_model import (FITTED_CONSTANT_FIELDS,  # noqa: F401
                                        FittedExecutor, InstanceCostModel)


class CalibrationRecorder:
    """Accumulates per-op engine timings for fitting and error reports.

    When a flight-recorder ``tracer`` is attached, every sample is also
    emitted as an ``op`` event — the same bus the simulator runs on, so
    sim-vs-real disagreement can be localized to a specific op/span
    rather than a run-level scalar."""

    tracer = NULL_TRACER

    def __init__(self) -> None:
        self.prefill: List[Tuple[int, float]] = []      # (tokens, dt)
        self.decode: List[Tuple[int, int, float]] = []  # (batch, ctx_sum, dt)

    def record_prefill(self, tokens: int, dt: float) -> None:
        self.prefill.append((int(tokens), float(dt)))
        trc = self.tracer
        if trc.enabled:
            trc.op(trc.now(), "prefill", int(tokens), 0, float(dt))

    def record_decode(self, batch: int, ctx_sum: int, dt: float) -> None:
        self.decode.append((int(batch), int(ctx_sum), float(dt)))
        trc = self.tracer
        if trc.enabled:
            trc.op(trc.now(), "decode", int(batch), int(ctx_sum), float(dt))

    def __len__(self) -> int:
        return len(self.prefill) + len(self.decode)


def fit_constants(rec: CalibrationRecorder) -> Dict[str, float]:
    """Least-squares fit of the FittedExecutor linear forms.

    prefill: dt ~ base + per_token * tokens
    decode:  dt ~ base + per_seq * batch + per_ctx_token * ctx_sum

    Negative coefficients are clamped to zero (a timing model must be
    monotone in work); degenerate sample sets (every prefill the same
    length, or too few rows for the design matrix) fall back to a pure
    per-token median so the fit never explodes.
    """
    out: Dict[str, float] = {}

    if rec.prefill:
        toks = np.array([t for t, _ in rec.prefill], dtype=float)
        dts = np.array([d for _, d in rec.prefill], dtype=float)
        if len(rec.prefill) >= 2 and len(set(toks.tolist())) >= 2:
            design = np.stack([np.ones_like(toks), toks], axis=1)
            coef, *_ = np.linalg.lstsq(design, dts, rcond=None)
            base, per_tok = float(coef[0]), float(coef[1])
        else:
            base, per_tok = 0.0, float(np.median(dts / np.maximum(toks, 1)))
        out["prefill_base"] = max(base, 0.0)
        out["prefill_per_token"] = max(per_tok, 0.0)

    if rec.decode:
        batch = np.array([b for b, _, _ in rec.decode], dtype=float)
        ctx = np.array([c for _, c, _ in rec.decode], dtype=float)
        dts = np.array([d for _, _, d in rec.decode], dtype=float)
        design = np.stack([np.ones_like(batch), batch, ctx], axis=1)
        if len(rec.decode) >= 3 and np.linalg.matrix_rank(design) == 3:
            coef, *_ = np.linalg.lstsq(design, dts, rcond=None)
            base, per_seq, per_ctx = (float(coef[0]), float(coef[1]),
                                      float(coef[2]))
        else:
            base = 0.0
            per_seq = float(np.median(dts / np.maximum(batch, 1)))
            per_ctx = 0.0
        out["decode_base"] = max(base, 0.0)
        out["decode_per_seq"] = max(per_seq, 0.0)
        out["decode_per_ctx_token"] = max(per_ctx, 0.0)

    return out


# --------------------------------------------------------------------- #
def _predict_prefill(model, tokens: int) -> float:
    return model.prefill_time([tokens])


def _predict_decode(model, batch: int, ctx_sum: int) -> float:
    try:
        return model.decode_time(batch, ctx_sum=ctx_sum)
    except TypeError:
        # shape-only executors without the ctx_sum keyword fast path
        return model.decode_time(batch, [ctx_sum])


def _rel_errors(rec: CalibrationRecorder, model) -> Tuple[List[float],
                                                          List[float]]:
    """Per-op |predicted - measured| / measured, prefill and decode."""
    pre = [abs(_predict_prefill(model, t) - dt) / dt
           for t, dt in rec.prefill if dt > 0]
    dec = [abs(_predict_decode(model, b, c) - dt) / dt
           for b, c, dt in rec.decode if dt > 0]
    return pre, dec


def _quantiles(pre: List[float], dec: List[float]) -> Dict[str, float]:
    def q(xs: List[float], p: float) -> float:
        return float(np.quantile(np.array(xs), p)) if xs else 0.0
    both = pre + dec
    return {
        "prefill_median": q(pre, 0.5), "prefill_p90": q(pre, 0.9),
        "decode_median": q(dec, 0.5), "decode_p90": q(dec, 0.9),
        "overall_median": q(both, 0.5),
    }


@dataclasses.dataclass
class CalibrationReport:
    """JSON-safe comparison of measured step times vs model predictions."""
    n_prefill: int
    n_decode: int
    unfitted: Dict[str, float]   # rel-error quantiles of the analytic model
    fitted: Dict[str, float]     # rel-error quantiles after the lstsq fit
    constants: Dict[str, float]  # the fitted FittedExecutor constants
    meta: Dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, rec: CalibrationRecorder, model,
              like: Optional[InstanceCostModel] = None,
              meta: Optional[Dict] = None) -> "CalibrationReport":
        consts = fit_constants(rec)
        fitted_model = FittedExecutor.from_constants(
            consts, like=like if like is not None else
            (model if isinstance(model, InstanceCostModel) else None))
        un_pre, un_dec = _rel_errors(rec, model)
        fi_pre, fi_dec = _rel_errors(rec, fitted_model)
        return cls(
            n_prefill=len(rec.prefill), n_decode=len(rec.decode),
            unfitted=_quantiles(un_pre, un_dec),
            fitted=_quantiles(fi_pre, fi_dec),
            constants=fitted_model.to_json(),
            meta=dict(meta or {}))

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "CalibrationReport":
        return cls(n_prefill=d["n_prefill"], n_decode=d["n_decode"],
                   unfitted=dict(d["unfitted"]), fitted=dict(d["fitted"]),
                   constants=dict(d["constants"]), meta=dict(d.get("meta",
                                                                   {})))

    def save(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=True)
            fh.write("\n")


def load_report(path) -> CalibrationReport:
    with open(path) as fh:
        return CalibrationReport.from_dict(json.load(fh))


def load_fitted_executor(path, like: Optional[InstanceCostModel] = None
                         ) -> FittedExecutor:
    """Runner hook: turn a saved CalibrationReport into the executor a
    simulator cell schedules with (``ExperimentRunner.calibration``)."""
    report = load_report(path)
    return FittedExecutor.from_constants(report.constants, like=like)


# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SyntheticTruth:
    """Deterministic 'ground truth' executor for fake-backend calibration:
    an affine warp of a base analytic model, so the fitted constants have
    a known target and the calibration golden is reproducible without
    hardware."""
    base: object
    prefill_scale: float = 1.0
    prefill_offset: float = 0.0
    decode_scale: float = 1.0
    decode_offset: float = 0.0

    def prefill_time(self, prompt_lens, kv_prefix_lens=None) -> float:
        if not prompt_lens:
            return 0.0
        return (self.prefill_scale
                * self.base.prefill_time(prompt_lens, kv_prefix_lens)
                + self.prefill_offset)

    def decode_time(self, batch_size, ctx_lens=None, *,
                    ctx_sum=None) -> float:
        if batch_size == 0:
            return 0.0
        return (self.decode_scale
                * _predict_decode(self.base, batch_size,
                                  ctx_sum if ctx_sum is not None
                                  else sum(ctx_lens or []))
                + self.decode_offset)
