"""Sarathi-style NoDG baseline: hybrid batching + chunked prefill,
decode-priority (paper §4.1 baseline 2).

Every iteration fuses the running decode batch with up to ``chunk_tokens``
of prefill work taken from the head of the prompt queue; a prompt's
prefill spreads over several iterations, re-reading its KV prefix each
time (the overhead the paper calls out).  The system layer is the same
immediate/least-KV policy bundle as vLLM — only the instance's intra-slot
rule differs — so ``"sarathi+priority"`` composes the SLO-aware queue
onto chunked prefill for free.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.instance import Instance
from repro_torch.core.request import Request, RequestState
from repro_torch.core.system import PolicySystemBase
from repro_torch.simulator.cost_model import InstanceCostModel


class SarathiInstance(Instance):
    def __init__(self, iid, executor, kv_capacity_tokens,
                 chunk_tokens: int = 512, **kw):
        super().__init__(iid, executor, kv_capacity_tokens, **kw)
        self.chunk_tokens = chunk_tokens
        self._progress = {}        # rid -> prefilled tokens

    def next_slot(self, now: float):
        if not self.pending and not self.decoding:
            self.phase = "idle"
            return "idle", 0.0, []
        # build the chunk set from pending prompts (decode-priority: the
        # decode batch always rides along; chunks fill the leftover budget)
        chunks: List[Tuple[Request, int, int]] = []   # (req, chunk, prefix)
        budget = self.chunk_tokens
        for r in self.pending:
            if budget <= 0:
                break
            done = self._progress.get(r.rid, 0)
            take = min(budget, r.prompt_len - done)
            if take > 0:
                chunks.append((r, take, done))
                budget -= take
        decode_batch = self.decoding[: self.max_decode_batch]
        dur = self._hybrid_iter_time(
            [c[1] for c in chunks], [c[2] for c in chunks], decode_batch)
        self.phase = "hybrid"
        self._current_chunks = chunks
        return "hybrid", dur, decode_batch

    def complete_slot(self, kind: str, reqs, t_end: float):
        finished = []
        if kind != "hybrid":
            return super().complete_slot(kind, reqs, t_end)
        # decode side
        for r in reqs:
            self._gen_token(r)
            if r.tokens_generated == 2:
                r.second_token_time = t_end
            if r.tokens_generated >= r.output_len:
                r.state = RequestState.FINISHED
                r.finish_time = t_end
                self.remove_decoding(r)
                finished.append(r)
        self._touch()
        # prefill chunks
        for r, take, done in self._current_chunks:
            new_done = done + take
            self._progress[r.rid] = new_done
            if new_done >= r.prompt_len:
                self.remove_pending(r)
                del self._progress[r.rid]
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


class SarathiSystem(PolicySystemBase):
    base_name = "sarathi"
    default_queue = "fifo"
    default_admission = "immediate"
    default_routing = "least-kv"

    def __init__(self, cost: InstanceCostModel, n_instances: int, slo=None,
                 chunk_tokens: int = 512,
                 queue_discipline=None, admission=None, routing=None,
                 failure=None, iid_base: int = 0):
        self.chunk_tokens = chunk_tokens
        super().__init__(cost, n_instances, slo,
                         queue_discipline=queue_discipline,
                         admission=admission, routing=routing,
                         failure=failure, iid_base=iid_base)

    def _make_instance(self, iid: int) -> Instance:
        return SarathiInstance(iid, self.cost,
                               self.cost.kv_capacity_tokens(),
                               chunk_tokens=self.chunk_tokens)
