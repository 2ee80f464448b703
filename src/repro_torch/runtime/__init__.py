"""Role-0 drivers and the simulation layer beneath them.

Three runtimes, as in the JAX package:

* ``serial``    — the paper's schedule as written; baseline clock.
* ``pipelined`` — microbatch pipelining at staleness 0: gradients equal
  ``protocol_step``'s; only the clock improves.
* ``nowait``    — bounded staleness: a client whose cut misses the
  deadline is imputed from its EMA (:mod:`repro_torch.core.straggler`)
  and skips that microbatch's jacobian, so a straggler never stalls a
  merge.

Layout: ``links`` (per-link latency/bandwidth and compute rates),
``clock`` (event heap and FIFO resources), ``topology`` (the aggregation
tree the engine clocks), ``engine`` (``StepPlan``, ``simulate_serial`` /
``simulate_pipelined`` and the ``pipelined_step`` wrapper), ``deadline``
(adaptive no-wait windows from per-client arrival EWMAs), ``executor``
(the Executor, which moves real payloads over any transport, and the
merge fast path), ``pipeline`` (``StepPipeline``, the cross-step window
driver) and ``serve_driver`` (the serving driver).  The simulation layer
runs on the host only and holds no tensors.
"""
from repro_torch.runtime.clock import EventClock, Resource
from repro_torch.runtime.deadline import AdaptiveDeadline
from repro_torch.runtime.engine import (
    MODES,
    SimReport,
    StepPlan,
    default_deadline_s,
    pipelined_step,
    plan_from_arch,
    plan_step,
    simulate_pipelined,
    simulate_serial,
)
from repro_torch.runtime.executor import (
    ExecReport,
    ExecutionResult,
    Executor,
    fast_merge,
)
from repro_torch.runtime.links import LinkModel
from repro_torch.runtime.pipeline import StepPipeline
from repro_torch.runtime.serve_driver import ServeDriver
from repro_torch.runtime.topology import TREE_VERIFY_ATOL, AggTree

__all__ = [
    "AdaptiveDeadline",
    "AggTree",
    "TREE_VERIFY_ATOL",
    "EventClock",
    "ExecReport",
    "ExecutionResult",
    "Executor",
    "Resource",
    "LinkModel",
    "ServeDriver",
    "MODES",
    "SimReport",
    "StepPipeline",
    "StepPlan",
    "default_deadline_s",
    "fast_merge",
    "pipelined_step",
    "plan_from_arch",
    "plan_step",
    "simulate_pipelined",
    "simulate_serial",
]
