"""Transport layer: the feature-holder worker, the inline backend, the
threaded one and the process one (one spawned process per feature holder,
TCP loopback; :mod:`repro_torch.transport.multiproc`).

Transport contract (star topology, role 0 is the caller): ``submit(client,
request)`` — FIFO per client, non-blocking; ``next_response(timeout)`` —
the next ``(client, response)`` from any client, or ``None``; ``close()``.

Worker ops (:data:`repro_torch.transport.ops.WORKER_OPS`):

* ``forward {step, mb[, feats]}`` -> ``cut {step, mb, cut}`` (features come
  inline or from the worker's own ``feature_fn``)
* ``backward {step, mb, jac}`` -> ``grad {step, mb}``, or the deferred
  ``step_done`` when it completes a waiting ``finish_step``
* ``finish_step {step, microbatches, collect, expected_jacs}`` ->
  ``step_done {step[, grad]}`` (local optimizer update when configured)
* ``serve_prefill {request, tokens, cache_len}`` -> ``serve_prefill_cut
  {request, cut}`` (opens or resets the request's tower KV session)
* ``serve_decode {request, token, pos}`` -> ``serve_cut {request, pos,
  cut}`` (checks ``pos`` against the session clock)
* ``serve_end {request}`` -> no response (drops the session)
* ``get_params {}`` -> ``params {params}``
* ``shutdown {}`` -> ``bye {}``
"""
from repro_torch.transport.base import SimTransport, TowerWorker, Transport
from repro_torch.transport.builders import (build_mlp_worker,
                                             build_split_worker)
from repro_torch.transport.inproc import InprocTransport
from repro_torch.transport.multiproc import MultiprocTransport, WorkerSpec

TRANSPORTS = ("sim", "inproc", "multiproc")

__all__ = ["TRANSPORTS", "InprocTransport", "MultiprocTransport",
           "SimTransport", "TowerWorker", "Transport", "WorkerSpec",
           "build_mlp_worker", "build_split_worker"]
