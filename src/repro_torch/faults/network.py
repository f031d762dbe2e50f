"""Seeded, pure-sim-time network degradation plane.

The fault-spec grammar (``repro_torch.faults.schedule``) gains four network
clauses — positional arguments, unlike the instance clauses' ``k=v``
form, because each is a single magnitude plus an optional episode
length:

* ``netdelay:ms[:dur]``   — every message gains ``ms`` milliseconds of
  latency (whole run, or an episode of ``dur`` seconds starting at a
  seeded uniform time)
* ``netloss:p[:dur]``     — each message is lost with probability ``p``
* ``netdegrade:F[:dur]``  — link bandwidth divides by ``F``
* ``partition:dur``       — one seeded victim instance is cut off from
  the coordination plane for ``dur`` seconds (messages to/from it are
  lost; routing fails over around it)

The injector applies these events to the system transport's
``NetworkModel`` — a bag of currently-active episode effects plus a
counter-keyed hash RNG.  Per-message randomness (loss draws, backoff
jitter) is a pure function of (schedule seed, message id, attempt), so
transport behaviour is bit-reproducible across runs and worker counts
regardless of how messages interleave with other events.
"""
from __future__ import annotations

import zlib
from typing import Dict, List

NETWORK_KINDS = ("netdelay", "netloss", "netdegrade", "partition")


class NetworkModel:
    """Currently-active degradation effects + the deterministic RNG the
    transport draws from.  Episodes are toggled by injector events
    (``apply``/``revert``, ``begin_partition``/``end_partition``); the
    model itself holds no schedule."""

    def __init__(self, seed: int):
        self.seed = int(seed) & 0xFFFFFFFF
        self._delay = 0.0                # summed active netdelay (s)
        self._degrade = 1.0              # product of active netdegrade Fs
        self._loss_terms: List[float] = []   # active netloss probabilities
        self._partitioned: Dict[int, int] = {}   # iid -> episode count

    # ---------------- state reads --------------------------------------- #
    def delay(self) -> float:
        return self._delay

    def degrade(self) -> float:
        return self._degrade

    def loss(self) -> float:
        """Combined per-message loss probability of the active episodes
        (independent-loss composition: 1 - prod(1 - p))."""
        if not self._loss_terms:
            return 0.0
        keep = 1.0
        for p in self._loss_terms:
            keep *= 1.0 - p
        return 1.0 - keep

    def partitioned(self, iid: int) -> bool:
        return iid in self._partitioned

    # ---------------- episode toggles (fault injector) ------------------ #
    def apply(self, kind: str, value: float) -> None:
        if kind == "netdelay":
            self._delay += value
        elif kind == "netdegrade":
            self._degrade *= value
        elif kind == "netloss":
            self._loss_terms.append(value)
        else:
            raise KeyError(f"unknown network effect {kind!r}")

    def revert(self, kind: str, value: float) -> None:
        if kind == "netdelay":
            self._delay = max(0.0, self._delay - value)
        elif kind == "netdegrade":
            self._degrade = max(1.0, self._degrade / value)
        elif kind == "netloss":
            if value in self._loss_terms:
                self._loss_terms.remove(value)
        else:
            raise KeyError(f"unknown network effect {kind!r}")

    def begin_partition(self, iid: int) -> None:
        self._partitioned[iid] = self._partitioned.get(iid, 0) + 1

    def end_partition(self, iid: int) -> None:
        n = self._partitioned.get(iid, 0) - 1
        if n <= 0:
            self._partitioned.pop(iid, None)
        else:
            self._partitioned[iid] = n

    # ---------------- deterministic randomness -------------------------- #
    def draw(self, *key) -> float:
        """Uniform [0, 1) as a pure function of (seed, key): loss draws
        and backoff jitter are keyed by message id + attempt, never by a
        shared stream, so they are independent of event interleaving."""
        h = zlib.crc32(repr(key).encode(), self.seed)
        return (h & 0xFFFFFF) / float(1 << 24)
