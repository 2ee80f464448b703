"""Minimal discrete-event simulation core: a heap-ordered event clock plus
FIFO serial resources (a client's CPU, a link direction, the role-0 server).

Events fire in (time, insertion-order) so same-instant events are
deterministic — the whole runtime simulation is a pure function of the
step plan and link model, which the equivalence tests rely on.
"""
from __future__ import annotations

import heapq
from typing import Callable


class EventClock:
    def __init__(self) -> None:
        self.now = 0.0
        self._heap: list = []
        self._seq = 0

    def post(self, when: float, fn: Callable[[], None]) -> None:
        """Schedule ``fn`` at absolute time ``when`` (clamped to now)."""
        heapq.heappush(self._heap, (max(when, self.now), self._seq, fn))
        self._seq += 1

    def post_in(self, delay: float, fn: Callable[[], None]) -> None:
        self.post(self.now + delay, fn)

    def run(self) -> float:
        """Drain the event heap; returns the time of the last event."""
        while self._heap:
            when, _, fn = heapq.heappop(self._heap)
            self.now = when
            fn()
        return self.now


class Resource:
    """A serially-reusable resource: one job at a time, FIFO in event order."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.free_at = 0.0
        self.busy_s = 0.0

    def acquire(self, ready_s: float, duration_s: float) -> tuple[float, float]:
        """Claim the resource no earlier than ``ready_s``; returns
        (start, end) of the granted slot."""
        start = max(ready_s, self.free_at)
        end = start + duration_s
        self.free_at = end
        self.busy_s += duration_s
        return start, end

    def utilization(self, horizon_s: float) -> float:
        return self.busy_s / horizon_s if horizon_s > 0 else 0.0
