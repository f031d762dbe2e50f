"""Request lifecycle shared by the simulator and the real-exec engine."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"          # not yet admitted to an instance
    PENDING = "pending"        # admitted, waiting for a prefill slot
    DECODING = "decoding"      # prefill done, generating
    FINISHED = "finished"
    FAILED = "failed"          # lost to a fault past the retry budget


@dataclasses.dataclass
class Request:
    rid: int
    arrival_time: float
    prompt_len: int
    output_len: int                      # ground-truth generation length;
                                         # schedulers never read it directly
    # multi-tenant tag: which SLO class this request is scored against
    # (see ``repro_torch.core.slo.SLOClassSet``); single-tenant runs leave it at
    # DEFAULT_SLO_CLASS and behave exactly as before
    slo_class: str = "default"
    # fleet tag: which model the client asked for (``repro_torch.fleet`` routes
    # on it; trace converters preserve it from the raw logs).  None =
    # untagged — single-model systems never read it
    model: Optional[str] = None
    state: RequestState = RequestState.QUEUED
    # times this request was resubmitted after losing its instance to a
    # fault (repro_torch.faults); arrival_time is never reset on resubmission,
    # so TTFT keeps charging the full wait including lost work
    retries: int = 0

    # --- runtime bookkeeping -------------------------------------------- #
    admitted_time: Optional[float] = None
    first_token_time: Optional[float] = None   # prefill completion
    second_token_time: Optional[float] = None  # first decode iteration done
    finish_time: Optional[float] = None
    tokens_generated: int = 0
    instance_id: Optional[int] = None
    prompt_tokens: Optional[list] = None       # real-exec engine only
    generated: Optional[list] = None

    # ------------------------------------------------------------------ #
    @property
    def ttft(self) -> Optional[float]:
        """Paper §3.3: strict TTFT = prefill completion - arrival; includes
        queueing and phase-switching wait."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def avg_tpot(self) -> Optional[float]:
        """Mean time per output token, measured from the request's first
        decode iteration (paper §3.3: "the measurement of TPOT begins
        after the phase-switching delay" — the wait between prefill
        completion and the decode phase is charged to the strict TTFT,
        not to TPOT)."""
        if self.finish_time is None:
            return None
        if self.tokens_generated > 2 and self.second_token_time is not None:
            return ((self.finish_time - self.second_token_time)
                    / (self.tokens_generated - 2))
        if self.tokens_generated > 1 and self.first_token_time is not None:
            return ((self.finish_time - self.first_token_time)
                    / (self.tokens_generated - 1))
        return None

    def saved_tpot(self, now: float, slo_tpot: float) -> float:
        """Algorithm 2 line 15: accumulated decode slack."""
        if self.first_token_time is None:
            return 0.0
        return (self.tokens_generated * slo_tpot
                - (now - self.first_token_time))

    def kv_tokens(self) -> int:
        return self.prompt_len + self.tokens_generated
