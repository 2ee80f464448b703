"""Cross-step pipelined driver over the Executor's submit/collect halves.

``Executor.run_step`` is a hard per-step barrier.  :class:`StepPipeline`
keeps up to ``window`` steps in flight: step t+1's tower forwards are
submitted (and, on a threaded transport, computed) while step t's server
backward and jacobian drain are still running.

* ``window=1`` — submit immediately followed by collect: the ``run_step``
  barrier.
* ``window=W>1`` — delayed gradients on the towers: a client computes step
  t's forward before step t-1's optimizer update has reached it
  (``ExecReport.staleness``); server params are never stale.

Typical drive loop (the shape ``train.loop.train_split`` uses; a no-wait
run threads the EMA state from each collect into the next)::

    pipeline = StepPipeline(executor, window=W)
    for step in range(steps):
        pipeline.submit(step, batch_ctx(next(it)))
        if pipeline.inflight >= W:
            res = pipeline.collect(server_params, ema_state=ema_state)
            ...apply server update, ema_state = res.ema_state...
    while pipeline.inflight:  # drain
        res = pipeline.collect(server_params, ema_state=ema_state)
        ...
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from repro_torch.core.protocol import Ledger
from repro_torch.runtime.executor import ExecutionResult, Executor


class StepPipeline:
    """Windowed cross-step driver: at most ``window`` steps between
    ``submit`` and ``collect``."""

    def __init__(self, executor: Executor, window: int = 1):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.executor = executor
        self.window = window
        self._pending: deque[int] = deque()

    @property
    def inflight(self) -> int:
        """Steps submitted but not yet collected."""
        return len(self._pending)

    @property
    def next_collect(self) -> Optional[int]:
        """The step the next :meth:`collect` will return, else ``None``."""
        return self._pending[0] if self._pending else None

    def submit(self, step: int, labels, *, features: Optional[list] = None,
               ledger: Optional[Ledger] = None) -> None:
        """Ship ``step``'s tower forwards (non-blocking on a threaded
        transport)."""
        if self._pending and step <= self._pending[-1]:
            raise ValueError(
                f"steps must be submitted in order; got {step} after "
                f"{self._pending[-1]}")
        self.executor.submit_step(step, labels, features=features,
                                  ledger=ledger)
        self._pending.append(step)

    def collect(self, server_params, **collect_kwargs) -> ExecutionResult:
        """Collect the oldest in-flight step (``liveness`` / ``merge_mask``
        / ``ema_state`` / ``collect_grads`` / ``report`` pass through to
        :meth:`Executor.collect_step`)."""
        if not self._pending:
            raise RuntimeError("pipeline empty: nothing to collect")
        res = self.executor.collect_step(server_params, **collect_kwargs)
        # pop only after a successful collect, so a raising collect_step
        # leaves the bookkeeping aligned with the executor's state
        self._pending.popleft()
        return res
