"""The worker op table — the wire verbs a port worker serves.

:class:`~repro_torch.transport.base.TowerWorker.handle` dispatches requests
from this table.  This slice carries the serving verbs plus the two
housekeeping verbs; the training verbs (``forward``, ``backward``,
``finish_step``, ...) come with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class OpSpec:
    """One worker-served wire verb.  ``handler`` is the ``TowerWorker``
    method ``handle`` dispatches to; ``responses`` are the response ops it
    may emit (empty: fire-and-forget, the driver must not wait)."""

    op: str
    handler: str
    responses: tuple[str, ...]
    doc: str


WORKER_OPS: dict[str, OpSpec] = {spec.op: spec for spec in (
    OpSpec("serve_prefill", "_serve_prefill", ("serve_prefill_cut",),
           "run the tower's feature slice over the whole prompt once and "
           "open (or reset) the request's tower KV session"),
    OpSpec("serve_decode", "_serve_decode", ("serve_cut",),
           "one autoregressive step against the request's KV session"),
    OpSpec("serve_end", "_serve_end", (),
           "drop the request's tower KV session (fire-and-forget)"),
    OpSpec("get_params", "_get_params", ("params",),
           "return this client's tower params (verification/collection)"),
    OpSpec("shutdown", "_shutdown", ("bye",),
           "close down; the transport retires the worker on the ack"),
)}
