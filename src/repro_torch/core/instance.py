"""Instance: one model replica with temporal prefill/decode disaggregation.

This is the paper's *instance scheduler* (Fig. 5 step 5).  The instance is
execution-backend agnostic: durations come from an ``ExecutorModel``
(analytical cost model in the simulator; measured wall-clock in the
real-exec engine).  Scheduling policy (PaDG intra-instance rule):

  * prefills are prioritized — whenever admitted prefills are pending,
    the next slot is a prefill batch;
  * otherwise run one decode iteration over the running batch;
  * each slot is an uninterruptible unit of work (phase switches happen
    only at slot boundaries, which is what makes the disaggregation
    *temporal*).

Hot-path accounting is incremental: the instance maintains running
aggregates (pending prefill tokens, decode KV/context sums) that are
updated in O(1) on every admit/complete/hand-off instead of re-summing
``self.pending``/``self.decoding`` at each slot boundary.  All membership
changes MUST therefore go through the mutator methods below
(``admit``/``remove_pending``/``add_decoding``/``remove_decoding``/
``sync_tokens``/``handoff_prefilled``) — never mutate the lists directly.
Every mutator bumps ``_version``, which invalidates the status cache and
the cached next-prefill-batch plan.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional, Protocol, Tuple

from repro_torch.core.request import Request, RequestState

if TYPE_CHECKING:
    from repro_torch.core.slo import SLOClassSet


class ExecutorModel(Protocol):
    def prefill_time(self, prompt_lens: List[int]) -> float: ...
    def decode_time(self, batch_size: int, ctx_lens: List[int]) -> float: ...
    # optional fast path (see InstanceCostModel): an integer `ctx_clamp`
    # attribute plus `decode_time(n, ctx_sum=...)` /
    # `hybrid_time(..., decode_ctx_sum=...)` keyword forms that take the
    # precomputed clamped-context sum instead of a per-sequence list
    # optional (EcoServe-CP): fused decode+chunk iteration
    # def hybrid_time(self, chunk_lens, prefix_lens, batch, ctxs): ...


@dataclasses.dataclass
class InstanceStatus:
    """What the instance periodically reports to its macro-instance
    scheduler (decode progress, memory, phase)."""
    iid: int
    phase: str                       # prefill | decode | idle
    pending_prefill_lens: List[int]
    pending_prefill_tokens: int
    num_decoding: int
    saved_tpots: List[float]
    kv_tokens_used: int
    kv_tokens_capacity: int
    last_switch_time: float
    # projected decode iteration time if one more request joins the batch
    # (guards TPOT against unbounded decode-batch growth)
    decode_iter_time_plus_one: float = 0.0
    # tightest TPOT budget among the decodes already running here (the
    # scalar instance SLO in single-class mode): admission must not slow
    # the shared decode batch past the strictest running tenant's budget
    decode_tpot_floor: float = float("inf")

    @property
    def kv_tokens_free(self) -> int:
        return self.kv_tokens_capacity - self.kv_tokens_used


class Instance:
    """Simulation-state instance; also the scheduling brain reused by the
    real-exec engine (which overrides the executor with measured times)."""

    # FuDG prefill-only instances override this (see baselines)
    decode_here = True
    # cleared by the fault layer (repro_torch.faults) on crash / preemption
    # deadline; the engine discards in-flight slots of dead instances and
    # never activates them again
    alive = True

    def __init__(self, iid: int, executor: ExecutorModel,
                 kv_capacity_tokens: int,
                 max_prefill_tokens: int = 16_384,
                 max_decode_batch: int = 256,
                 max_prefill_batch: Optional[int] = None,
                 slo_tpot: Optional[float] = None,
                 slo_ttft: Optional[float] = None,
                 conservative_slack: bool = False,
                 chunked_fallback: int = 0,
                 slo_classes: Optional["SLOClassSet"] = None):
        self.iid = iid
        self.executor = executor
        self.kv_capacity_tokens = kv_capacity_tokens
        self.max_prefill_tokens = max_prefill_tokens
        self.max_decode_batch = max_decode_batch
        # Slot-coupled prefill cap (real-exec engines): each prefilled
        # request lands in one of ``max_prefill_batch`` physical decode
        # slots, so a prefill batch may take at most
        # ``max_prefill_batch - len(decoding)`` requests.  None (default)
        # keeps the simulator's token-bounded-only plan, bit-identically.
        self.max_prefill_batch = max_prefill_batch
        # PaDG intra-instance rule (§3.1): with a TPOT SLO known, the
        # instance keeps decoding until its decodes have accumulated
        # enough slack to absorb the pending prefill slot.  None disables
        # the guard (NoDG baselines are strictly prefill-prioritized).
        self.slo_tpot = slo_tpot
        self.slo_ttft = slo_ttft
        # Multi-tenant SLO classes: when a heterogeneous class set is
        # attached, the slack guard and status report score every request
        # against ITS OWN class budget.  A single-class (or absent) set
        # keeps the scalar slo_tpot/slo_ttft code paths, bit-identically.
        self.slo_classes = slo_classes
        self._multi_slo = (slo_classes is not None
                           and not slo_classes.is_single)
        self.conservative_slack = conservative_slack  # EcoServe++ (min slack)
        # EcoServe-CP (beyond-paper): when decode slack is too thin for a
        # full prefill slot, ride `chunked_fallback` prefill tokens along
        # with the decode iteration (Sarathi-style chunk INSIDE PaDG) so
        # TTFT progresses without stalling decodes.  0 disables.
        self.chunked_fallback = chunked_fallback
        self._chunk_progress: dict = {}
        self._current_chunks: List = []

        self.pending: List[Request] = []      # admitted, waiting for prefill
        self.decoding: List[Request] = []
        self.phase = "idle"
        self.last_switch_time = 0.0
        self.busy_until = 0.0
        self._finished: List[Request] = []

        # ---- incremental aggregates (see module docstring) ------------- #
        # executors exposing ctx_clamp support the summed decode fast path
        self._ctx_clamp = int(getattr(executor, "ctx_clamp", 0) or 0)
        self._fast_ctx_sum = hasattr(executor, "ctx_clamp")
        self._pending_tokens = 0       # sum of prompt_len over pending
        self._decode_kv_sum = 0        # sum of r.kv_tokens() over decoding
        self._decode_eff_sum = 0       # same, clamped at _ctx_clamp
        self._version = 0              # bumped on any mutation
        self._status_cache = None      # ((now, slo, version), status)
        self._prefill_plan_cache = None  # (version, (batch, lens, dur, old))
        self._starve_deadline_cache = None  # (version, deadline) multi-SLO

    # ----------------------------------------------------------------- #
    # mutators: the ONLY legal way to change pending/decoding membership
    # ----------------------------------------------------------------- #
    def _touch(self) -> None:
        self._version += 1

    def _eff(self, kv: int) -> int:
        return min(kv, self._ctx_clamp) if self._ctx_clamp else kv

    def admit(self, req: Request, now: float) -> None:
        req.state = RequestState.PENDING
        req.admitted_time = now
        req.instance_id = self.iid
        self.pending.append(req)
        self._pending_tokens += req.prompt_len
        self._touch()

    def remove_pending(self, req: Request) -> None:
        self.pending.remove(req)
        self._pending_tokens -= req.prompt_len
        self._touch()

    def add_decoding(self, req: Request) -> None:
        kv = req.kv_tokens()
        self.decoding.append(req)
        self._decode_kv_sum += kv
        self._decode_eff_sum += self._eff(kv)
        self._touch()

    def remove_decoding(self, req: Request) -> None:
        kv = req.kv_tokens()
        self.decoding.remove(req)
        self._decode_kv_sum -= kv
        self._decode_eff_sum -= self._eff(kv)
        self._touch()

    def _gen_token(self, req: Request) -> None:
        """One decode token for a request currently in ``decoding``."""
        req.tokens_generated += 1
        self._decode_kv_sum += 1
        if not self._ctx_clamp or req.kv_tokens() <= self._ctx_clamp:
            self._decode_eff_sum += 1

    def sync_tokens(self, req: Request, tokens_generated: int) -> None:
        """Externally set ``req.tokens_generated`` (req must be in
        ``decoding``), keeping the running aggregates consistent — used by
        the real-exec server whose engine advances counts out-of-band."""
        old_kv = req.kv_tokens()
        req.tokens_generated = tokens_generated
        new_kv = req.kv_tokens()
        if new_kv != old_kv:
            self._decode_kv_sum += new_kv - old_kv
            self._decode_eff_sum += self._eff(new_kv) - self._eff(old_kv)
            self._touch()

    def handoff_prefilled(self, reqs: List[Request], t_end: float) -> None:
        """FuDG prefill-only instance: mark first token and release the
        batch for transfer to a decode instance."""
        for r in reqs:
            self.remove_pending(r)
            r.first_token_time = t_end
            r.tokens_generated = 1

    def set_executor(self, executor: ExecutorModel) -> None:
        """Swap the executor in place (straggler-slowdown wrapper,
        repro_torch.faults), re-deriving the fast-path markers and invalidating
        every duration cache.  The incremental aggregates are
        executor-independent, so membership state carries over."""
        self.executor = executor
        new_clamp = int(getattr(executor, "ctx_clamp", 0) or 0)
        if new_clamp != self._ctx_clamp:
            # the clamped decode-context sum depends on the clamp value
            self._ctx_clamp = new_clamp
            self._decode_eff_sum = sum(
                self._eff(r.kv_tokens()) for r in self.decoding)
        self._fast_ctx_sum = hasattr(executor, "ctx_clamp")
        self._touch()

    def kv_tokens_used(self) -> int:
        return self._decode_kv_sum + self._pending_tokens

    @property
    def pending_tokens(self) -> int:
        """Total prompt tokens awaiting prefill (O(1))."""
        return self._pending_tokens

    def audit_aggregates(self) -> dict:
        """(incremental, recomputed-from-scratch) pairs — test hook for
        the accounting invariants."""
        eff = (lambda kv: min(kv, self._ctx_clamp)) if self._ctx_clamp \
            else (lambda kv: kv)
        return {
            "pending_tokens": (
                self._pending_tokens,
                sum(r.prompt_len for r in self.pending)),
            "decode_kv_sum": (
                self._decode_kv_sum,
                sum(r.kv_tokens() for r in self.decoding)),
            "decode_eff_sum": (
                self._decode_eff_sum,
                sum(eff(r.kv_tokens()) for r in self.decoding)),
        }

    # ----------------------------------------------------------------- #
    def status(self, now: float, slo_tpot: float) -> InstanceStatus:
        # memoized per (now, slo, version): Algorithm 1 probes every
        # instance for every queued request at each slot boundary, and
        # every mutator bumps _version — stale entries are impossible.
        # In multi-SLO mode _status ignores the scalar slo_tpot (each
        # decode uses its own class budget), so the key normalizes it —
        # interleaved-class dispatch must not thrash the one-entry cache
        key = (now, None if self._multi_slo else slo_tpot, self._version)
        cached = self._status_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        st = self._status(now, slo_tpot)
        self._status_cache = (key, st)
        return st

    def _status(self, now: float, slo_tpot: float) -> InstanceStatus:
        n_next = min(len(self.decoding) + 1, self.max_decode_batch)
        if self._fast_ctx_sum and n_next - 1 == len(self.decoding):
            dit = self.executor.decode_time(
                n_next, ctx_sum=self._decode_eff_sum + self._eff(512))
        else:
            ctxs = [r.kv_tokens() for r in self.decoding][: n_next - 1]
            dit = self.executor.decode_time(n_next, ctxs + [512])
        if self._multi_slo:
            # each decode's slack accrues against its OWN class's TPOT
            classes = self.slo_classes
            tpots = [classes.for_request(r).tpot for r in self.decoding]
            saved = [r.saved_tpot(now, t)
                     for r, t in zip(self.decoding, tpots)]
            floor = min(tpots) if tpots else float("inf")
        else:
            saved = [r.saved_tpot(now, slo_tpot) for r in self.decoding]
            floor = slo_tpot if slo_tpot is not None else float("inf")
        return InstanceStatus(
            iid=self.iid,
            phase=self.phase,
            pending_prefill_lens=[r.prompt_len for r in self.pending],
            pending_prefill_tokens=self._pending_tokens,
            num_decoding=len(self.decoding),
            saved_tpots=saved,
            kv_tokens_used=self.kv_tokens_used(),
            kv_tokens_capacity=self.kv_capacity_tokens,
            last_switch_time=self.last_switch_time,
            decode_iter_time_plus_one=dit,
            decode_tpot_floor=floor,
        )

    # ----------------------------------------------------------------- #
    def _decode_iter_time(self, batch: List[Request]) -> float:
        """Duration of one decode iteration over ``batch``: the O(1)
        ctx-sum fast path when the executor supports it and the batch is
        the whole decode set, else the per-request list path."""
        if self._fast_ctx_sum and len(batch) == len(self.decoding):
            return self.executor.decode_time(
                len(batch), ctx_sum=self._decode_eff_sum)
        return self.executor.decode_time(
            len(batch), [r.kv_tokens() for r in batch])

    def _hybrid_iter_time(self, chunk_lens: List[int],
                          prefix_lens: List[int],
                          batch: List[Request]) -> float:
        """Duration of one fused decode+chunk iteration (same fast-path
        rule as ``_decode_iter_time``)."""
        if self._fast_ctx_sum and len(batch) == len(self.decoding):
            return self.executor.hybrid_time(
                chunk_lens, prefix_lens, len(batch),
                decode_ctx_sum=self._decode_eff_sum)
        return self.executor.hybrid_time(
            chunk_lens, prefix_lens, len(batch),
            [r.kv_tokens() for r in batch])

    # ----------------------------------------------------------------- #
    def _prefill_plan(self) -> Tuple[List[Request], List[int], float, float]:
        """The actual next prefill batch (respecting max_prefill_tokens
        and chunk progress), its duration, and the oldest pending arrival
        — computed once per mutation and reused by both the slack guard
        and ``next_slot``."""
        cached = self._prefill_plan_cache
        if cached is not None and cached[0] == self._version:
            return cached[1]
        batch: List[Request] = []
        lens: List[int] = []
        tokens = 0
        # physical decode slots still free (None = unconstrained; the
        # plan may then legitimately be empty when every slot is decoding)
        limit = None if self.max_prefill_batch is None else max(
            0, self.max_prefill_batch - len(self.decoding))
        for r in self.pending:
            if limit is not None and len(batch) >= limit:
                break
            remaining = r.prompt_len - self._chunk_progress.get(r.rid, 0)
            if batch and tokens + remaining > self.max_prefill_tokens:
                break
            batch.append(r)
            lens.append(remaining)
            tokens += remaining
        dur = self.executor.prefill_time(lens) if lens else 0.0
        oldest = min(r.arrival_time for r in self.pending) \
            if self.pending else 0.0
        plan = (batch, lens, dur, oldest)
        self._prefill_plan_cache = (self._version, plan)
        return plan

    def next_slot(self, now: float) -> Tuple[str, float, List[Request]]:
        """Decide and 'execute' the next slot starting at ``now``.

        Returns (kind, duration, affected requests).  kind == "idle" means
        nothing to do.  The caller (event engine) applies completion at
        now + duration via ``complete_slot``.
        """
        if self.pending and self._slack_allows_prefill(now):
            batch, _, dur, _ = self._prefill_plan()
            # an empty plan (every physical slot busy decoding under
            # ``max_prefill_batch``) falls through to a decode iteration
            if batch:
                if self.phase != "prefill":
                    self.phase = "prefill"
                    self.last_switch_time = now
                return "prefill", dur, batch
        if self.decoding:
            batch = self.decoding[: self.max_decode_batch]
            if self.pending and self.chunked_fallback:
                # EcoServe-CP: hybrid iteration (decode + prefill chunk)
                chunks = []
                budget = self.chunked_fallback
                for r in self.pending:
                    if budget <= 0:
                        break
                    done = self._chunk_progress.get(r.rid, 0)
                    take = min(budget, r.prompt_len - done)
                    if take > 0:
                        chunks.append((r, take, done))
                        budget -= take
                dur = self._hybrid_iter_time(
                    [c[1] for c in chunks], [c[2] for c in chunks], batch)
                self._current_chunks = chunks
                self.phase = "hybrid"
                return "hybrid", dur, batch
            dur = self._decode_iter_time(batch)
            if self.phase != "decode":
                self.phase = "decode"
                self.last_switch_time = now
            return "decode", dur, batch
        self.phase = "idle"
        return "idle", 0.0, []

    def _slack_allows_prefill(self, now: float) -> bool:
        """§3.1: execute decodes until enough TPOT slack has accumulated to
        absorb the pending prefill slot without violating running decodes.
        Costs the *actual* next prefill batch (what ``next_slot`` would
        run), cached until the pending set changes."""
        if self.slo_tpot is None or not self.decoding:
            return True
        if self._multi_slo:
            return self._slack_allows_prefill_per_class(now)
        _, _, dur, oldest = self._prefill_plan()
        # anti-starvation: a pending prefill nearing its TTFT budget wins
        if self.slo_ttft is not None:
            if now - oldest + dur > 0.6 * self.slo_ttft:
                return True
        saved = [r.saved_tpot(now, self.slo_tpot) for r in self.decoding]
        slack = min(saved) if self.conservative_slack else (
            sum(saved) / len(saved))
        return slack >= dur

    def _starvation_deadline(self) -> float:
        """Earliest anti-starvation deadline over the pending set:
        min(arrival + 0.6 * own-class TTFT).  Depends only on pending
        membership, so it is cached per mutation version like the
        prefill plan — the per-class guard stays O(1) per probe instead
        of rescanning the queue at every slot decision."""
        cached = self._starve_deadline_cache
        if cached is not None and cached[0] == self._version:
            return cached[1]
        classes = self.slo_classes
        deadline = min(
            (r.arrival_time + 0.6 * classes.for_request(r).ttft
             for r in self.pending), default=float("inf"))
        self._starve_deadline_cache = (self._version, deadline)
        return deadline

    def _slack_allows_prefill_per_class(self, now: float) -> bool:
        """Multi-tenant form of the guard: the anti-starvation check uses
        each pending request's OWN TTFT budget (a tight-class prefill can
        force the switch while a lax-class one keeps waiting), and decode
        slack accrues against each decode's OWN TPOT budget."""
        classes = self.slo_classes
        _, _, dur, _ = self._prefill_plan()
        # some pending prefill past 60% of its own TTFT budget wins
        if now + dur > self._starvation_deadline():
            return True
        saved = [r.saved_tpot(now, classes.for_request(r).tpot)
                 for r in self.decoding]
        slack = min(saved) if self.conservative_slack else (
            sum(saved) / len(saved))
        return slack >= dur

    def complete_slot(self, kind: str, reqs: List[Request],
                      t_end: float) -> List[Request]:
        """Apply slot completion; returns requests finished in this slot."""
        finished: List[Request] = []
        if kind == "prefill":
            for r in reqs:
                self.remove_pending(r)
                self._chunk_progress.pop(r.rid, None)
                r.first_token_time = t_end
                r.tokens_generated = 1
                if r.tokens_generated >= r.output_len:
                    r.state = RequestState.FINISHED
                    r.finish_time = t_end
                    finished.append(r)
                else:
                    r.state = RequestState.DECODING
                    self.add_decoding(r)
        elif kind in ("decode", "hybrid"):
            for r in reqs:
                self._gen_token(r)
                if r.tokens_generated == 2:
                    r.second_token_time = t_end
                if r.tokens_generated >= r.output_len:
                    r.state = RequestState.FINISHED
                    r.finish_time = t_end
                    self.remove_decoding(r)
                    finished.append(r)
            self._touch()   # decode token counts changed
            if kind == "hybrid":
                for r, take, done in self._current_chunks:
                    new_done = done + take
                    self._chunk_progress[r.rid] = new_done
                    self._touch()   # chunk progress feeds _prefill_plan
                    if new_done >= r.prompt_len:
                        self.remove_pending(r)
                        del self._chunk_progress[r.rid]
                        r.first_token_time = t_end
                        r.tokens_generated = 1
                        if r.tokens_generated >= r.output_len:
                            r.state = RequestState.FINISHED
                            r.finish_time = t_end
                            finished.append(r)
                        else:
                            r.state = RequestState.DECODING
                            self.add_decoding(r)
                self._current_chunks = []
        self._finished.extend(finished)
        return finished

    # ----------------------------------------------------------------- #
    @property
    def busy(self) -> bool:
        return bool(self.pending or self.decoding)
