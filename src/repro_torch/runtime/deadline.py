"""Adaptive no-wait deadlines from per-client arrival EWMAs.

``default_deadline_s`` is a static per-step guess; this controller learns
the federation's actual arrival behavior online.  For every microbatch the
role-0 server observes each client's arrival *spread* — the delay behind
that microbatch's first cut — and keeps a per-client EWMA.  The next
deadline is::

    clamp(floor, slack * max(spread of healthy clients), ceiling)

where a client is healthy when its EWMA is below
``straggler_factor * median`` (or the floor, whichever is larger), the
floor is ``floor_frac * initial_s`` and the ceiling ``ceiling_frac *
initial_s``.  Healthy clients drifting slower LOOSEN the deadline so they
keep making the merge; a straggler is excluded from the max so the
deadline TIGHTENS back toward the floor instead of chasing it — and if the
straggler recovers, its decaying EWMA re-enters the healthy set and it
rejoins the merge.  Shared by the simulated clock
(``engine.simulate_pipelined``) and the wall-clock executor so both layers
exercise the same policy.
"""
from __future__ import annotations

from typing import Optional


def _median(values: list[float]) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class AdaptiveDeadline:
    def __init__(self, num_clients: int, initial_s: Optional[float] = None, *,
                 decay: float = 0.7, slack: float = 1.5,
                 floor_frac: float = 0.5, ceiling_frac: float = 4.0,
                 straggler_factor: float = 4.0):
        if num_clients < 1:
            raise ValueError("need at least one client")
        self.num_clients = num_clients
        self.initial_s = initial_s
        self.decay = decay
        self.slack = slack
        self.floor_frac = floor_frac
        self.ceiling_frac = ceiling_frac
        self.straggler_factor = straggler_factor
        self._ewma: list[Optional[float]] = [None] * num_clients

    def observe(self, client: int, spread_s: float) -> None:
        """Record one arrival: ``spread_s`` seconds behind the microbatch's
        first cut (the first arrival itself observes 0).  Late/discarded
        arrivals should be observed too — that is how a recovered straggler
        earns its way back under the deadline."""
        spread_s = max(float(spread_s), 0.0)
        prev = self._ewma[client]
        self._ewma[client] = spread_s if prev is None else (
            self.decay * prev + (1.0 - self.decay) * spread_s)

    def spreads(self) -> list[Optional[float]]:
        return list(self._ewma)

    def seed_from_observations(self, min_initial_s: float = 0.05) -> None:
        """Bootstrap ``initial_s`` after a full-barrier microbatch seeded
        the EWMAs.  Anchored on the MEDIAN spread so a straggler sitting in
        the barrier cannot inflate the baseline window (the floor keeps
        wall-clock jitter from starving healthy clients instead)."""
        if self.initial_s is not None:
            return
        seen = [e for e in self._ewma if e is not None]
        if not seen:
            return
        self.initial_s = max(self.straggler_factor * _median(seen),
                             min_initial_s)

    def deadline_s(self) -> Optional[float]:
        """Grace window after a microbatch's first arrival; ``None`` means
        "no estimate yet — wait for everyone" (the bootstrap barrier that
        seeds the EWMAs, used when ``initial_s`` is unknown)."""
        seen = [e for e in self._ewma if e is not None]
        if not seen:
            return self.initial_s
        if self.initial_s is None:
            return None
        floor = self.floor_frac * self.initial_s
        cut = max(floor, self.straggler_factor * _median(seen))
        healthy = [e for e in seen if e <= cut]
        want = self.slack * max(healthy) if healthy else self.initial_s
        return min(max(want, floor), self.ceiling_frac * self.initial_s)
