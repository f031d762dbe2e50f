"""The window's clock: ``WallClock``'s protocol (start, now, sleep_until)
on the host's ``perf_counter``, counting the seconds the served loop
sleeps, and calling ``on_time`` (the traced run's profiler switch) each
time the loop reads it."""
from __future__ import annotations

import time
from typing import Callable, Optional


class BenchClock:
    def __init__(self) -> None:
        self.t0: Optional[float] = None
        self.slept = 0.0                 # seconds inside sleep_until
        self.on_time: Optional[Callable[[float], None]] = None
        self.sleep_span: Optional[Callable[[], object]] = None

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self.slept = 0.0

    def now(self) -> float:
        if self.t0 is None:
            return 0.0
        t = time.perf_counter() - self.t0
        if self.on_time is not None:
            self.on_time(t)
        return t

    def sleep_until(self, t: float) -> None:
        dt = t - self.now()
        if dt <= 0:
            return
        t1 = time.perf_counter()
        if self.sleep_span is not None:
            with self.sleep_span():
                time.sleep(dt)
        else:
            time.sleep(dt)
        self.slept += time.perf_counter() - t1
