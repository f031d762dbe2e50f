"""Algorithm 2: Constraint Checking (verbatim from the paper).

Given an instance's status and an incoming request, verify that admitting
the request violates neither the TTFT SLO (constraint 1), the TPOT SLO of
the decodes already running there (constraint 2), nor the KV-cache memory
capacity (constraint 3).

Multi-tenant note: ``slo`` is the budget the INCOMING request is checked
against — under an ``SLOClassSet`` the router passes the request's own
class SLO here, and ``status.saved_tpots`` already accrues each running
decode's slack against that decode's own class TPOT (see
``Instance.status``), so constraint 2 stays per-tenant consistent.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.instance import InstanceStatus
from repro_torch.core.request import Request
from repro_torch.core.slo import SLO


def check_constraints(
    status: InstanceStatus,
    req: Request,
    slo: SLO,
    predict_prefill: Callable[[int], float],
    now: float,
    *,
    expected_kv_tokens: Optional[int] = None,
    conservative: bool = False,
) -> bool:
    # ---- Constraint 1: TTFT ------------------------------------------- #
    # pending prefills admitted since the phase switch, plus the new one
    t_total = sum(predict_prefill(n) for n in status.pending_prefill_lens)
    t_total += predict_prefill(req.prompt_len)
    # requests queue behind the prefills already pending on this instance;
    # the elapsed wait of the new request also counts against its TTFT
    already_waited = max(0.0, now - req.arrival_time)
    if t_total + already_waited > slo.ttft:
        return False

    # ---- Constraint 2: TPOT ------------------------------------------- #
    # inserting t_total of prefill work delays every running decode by
    # t_total; each decode has accumulated `saved_tpot` slack (line 15)
    if status.saved_tpots:
        if conservative:   # EcoServe++: protect the youngest decode too
            if min(status.saved_tpots) < t_total:
                return False
        else:              # paper Algorithm 2 line 16: mean
            mean_saved = sum(status.saved_tpots) / len(status.saved_tpots)
            if mean_saved < t_total:
                return False
    # 2b: the request's own decode joins the batch — the projected decode
    # iteration time must stay within the TPOT SLO ("prioritizing the
    # maintenance of satisfactory TPOT", §3.4).  The budget is the
    # tighter of the incoming request's class TPOT and the strictest
    # budget among decodes already running (``decode_tpot_floor``): a
    # lax-class admission must not slow the shared decode batch past a
    # tight-class tenant's SLO.  Single-class mode: floor == slo.tpot.
    if status.decode_iter_time_plus_one > min(slo.tpot,
                                              status.decode_tpot_floor):
        return False

    # ---- Constraint 3: KV cache capacity ------------------------------ #
    want = expected_kv_tokens if expected_kv_tokens is not None else (
        req.prompt_len * 2)   # prompt + headroom for generation
    if want > status.kv_tokens_free:
        return False
    return True
