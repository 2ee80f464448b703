"""Transport layer: the feature-holder worker and the inline backend.

Transport contract (star topology, role 0 is the caller): ``submit(client,
request)`` — FIFO per client, non-blocking; ``next_response(timeout)`` —
the next ``(client, response)`` from any client, or ``None``; ``close()``.

Worker ops of this slice (:data:`repro_torch.transport.ops.WORKER_OPS`):

* ``serve_prefill {request, tokens, cache_len}`` -> ``serve_prefill_cut
  {request, cut}`` (opens or resets the request's tower KV session)
* ``serve_decode {request, token, pos}`` -> ``serve_cut {request, pos,
  cut}`` (checks ``pos`` against the session clock)
* ``serve_end {request}`` -> no response (drops the session)
* ``get_params {}`` -> ``params {params}``
* ``shutdown {}`` -> ``bye {}``
"""
from repro_torch.transport.base import SimTransport, TowerWorker, Transport
from repro_torch.transport.builders import build_split_worker

__all__ = ["SimTransport", "TowerWorker", "Transport", "build_split_worker"]
