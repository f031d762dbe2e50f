"""How ``correct`` is decided for a served model.

After the window: every request's engine-side tokens must agree with the
scheduler's count (``token_count_errors``, limit 0).  Then a sample drawn
from the seed of the requests that finished, the one with the most served
tokens first, then others in the seed's order until ``check_tokens``
tokens or ``check_requests`` requests: the plain reference (the model
family's ``logits_at``) runs once over each prompt with its served tokens
(teacher-forced), and at each served position the gap between the
reference's best logit and the served token's logit is read.  The widest
gap over the sample (``widest_logit_gap``) is held to the configuration's
limit.  The control reads, at the same positions, the gap of the token
that the reference in float8 puts first.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

MIN_REQUESTS = 4        # prompts compared at least, where that many finished


def sample(done: Sequence[dict], seed: int, tokens: int,
           max_requests: int) -> List[dict]:
    """Finished requests to compare: the longest, then others in an order
    drawn from ``seed`` until ``tokens`` served tokens and
    ``MIN_REQUESTS`` requests, or ``max_requests`` requests."""
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r["generated"]), -r["rid"]))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed, 0x5a3]).permutation(len(rest))
    out = [longest]
    n = len(longest["generated"])
    for i in order:
        if (n >= tokens and len(out) >= MIN_REQUESTS) \
                or len(out) >= max_requests:
            break
        out.append(rest[i])
        n += len(rest[i]["generated"])
    return out


def _inputs(picked):
    seqs, rows = [], []
    for r in picked:
        p, g = r["prompt_tokens"], r["generated"]
        seqs.append(list(p) + list(g[:-1]))
        rows.append(range(len(p) - 1, len(p) - 1 + len(g)))
    return seqs, rows


def gaps(logits_at, w, m, picked, control_too: bool = False):
    """Per sampled request, the served tokens' gaps below the best logit
    of the reference ``logits_at``; with ``control_too`` also the gaps of
    the float8 reference's first choices.  Returns (served, control or
    None)."""
    seqs, rows = _inputs(picked)
    with torch.no_grad():
        ref = logits_at(w, m, seqs, rows)
        served = []
        for lg, r in zip(ref, picked):
            tok = torch.as_tensor(r["generated"], device=lg.device)
            best = lg.max(-1).values
            served.append((best - lg.gather(-1, tok[:, None])[:, 0]).cpu())
        ctrl = None
        if control_too:
            low = logits_at(w, m, seqs, rows, control=True)
            ctrl = []
            for lg, lo in zip(ref, low):
                pick = lo.argmax(-1)
                ctrl.append((lg.max(-1).values
                             - lg.gather(-1, pick[:, None])[:, 0]).cpu())
    return served, ctrl


def widest(per_request) -> float:
    return max((float(g.max()) for g in per_request if len(g)), default=0.0)


def token_count_errors(reqs: Sequence[dict], eos: int,
                       seq_cap: int) -> int:
    """Requests whose served tokens disagree with the scheduler's count, or
    that finished short of their length without EOS or the slot's cap."""
    bad = 0
    for r in reqs:
        n = len(r["generated"])
        if n != r["tokens_generated"]:
            bad += 1
        elif r["finished"] and n < r["asked"]:
            capped = r["prompt_len"] + n >= seq_cap - 2
            if not (r["generated"][-1] == eos or capped):
                bad += 1
    return bad
