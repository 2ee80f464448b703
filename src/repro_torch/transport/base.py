"""Transport interface + the feature-holder worker + the inline backend.

``TowerWorker`` is the feature-holder endpoint, transport-agnostic: it owns
this client's tower params and serves the ops of
:data:`repro_torch.transport.ops.WORKER_OPS`.  Backends differ only in
WHERE ``handle`` runs and how requests/responses move; this slice has the
inline :class:`SimTransport`, which keeps every payload a tensor on its
device (nothing is pickled).
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import torch

from repro_torch.core import compat
from repro_torch.transport import ops as ops_registry


class Transport:
    """Star-topology message plane; role 0 (the driver) is the caller."""

    num_clients: int

    def submit(self, client: int, request: dict) -> None:
        raise NotImplementedError

    def next_response(self, timeout: Optional[float] = None):
        """Next ``(client, response)`` from any client, else ``None`` on
        timeout.  FIFO per client; cross-client order is arrival order."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def __enter__(self) -> "Transport":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TowerWorker:
    """Role-1/3 endpoint serving split inference.

    ``serve_fns`` is the program's tower serving bundle
    (:class:`~repro_torch.models.split_program.TowerServeFns`); one tower KV
    session per in-flight request, keyed by request id, so a client serves
    many interleaved requests at heterogeneous positions.  ``compress`` is
    the config's cut codec, carried so the worker's own compat guard can
    refuse to serve under it (serving frames are raw cut tensors)."""

    def __init__(self, client_id: int, tower_params, *, serve_fns=None,
                 compress: Optional[str] = None,
                 device: Optional[torch.device] = None):
        self.client_id = client_id
        self.params = tower_params
        self.serve_fns = serve_fns
        self.compress = compress
        self.device = device
        self._serve_sessions: dict = {}  # request id -> tower KV session

    def handle(self, request: dict) -> Optional[dict]:
        """Dispatch one request through the op table."""
        op = request["op"]
        spec = ops_registry.WORKER_OPS.get(op)
        if spec is None:
            raise ValueError(f"unknown op {op!r}")
        return getattr(self, spec.handler)(request)

    def _serve_end(self, request: dict) -> None:
        # fire-and-forget session teardown: nothing to reply
        self._serve_sessions.pop(request["request"], None)
        return None

    def _get_params(self, request: dict) -> dict:
        return {"op": "params", "client": self.client_id,
                "params": self.params}

    def _shutdown(self, request: dict) -> dict:
        return {"op": "bye", "client": self.client_id}

    # -- serving ops --------------------------------------------------------

    def _require_serving(self) -> None:
        if self.serve_fns is None:
            raise ValueError(
                f"client {self.client_id}: no serve_fns configured — split "
                "serving needs the program's tower serving bundle "
                "(SplitProgram.tower_serve_fns; dense family only)")
        # the worker's own guard (it must not trust the driver)
        compat.check("worker", serve=True, compress=self.compress,
                     context=f"client {self.client_id}")

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def _serve_prefill(self, request: dict) -> dict:
        """One-time per-request tower prefill: embed the prompt through the
        private embedding columns, fill a fresh tower KV session, uplink
        the full-prompt cut slice.  Re-prefilling an existing request id
        RESETS its session (the driver's readmission path)."""
        self._require_serving()
        rid = request["request"]
        tokens = self._tokens(request["tokens"]).reshape(1, -1)
        cut, session = self.serve_fns.prefill(
            self.params, tokens, int(request["cache_len"]))
        self._serve_sessions[rid] = session
        return {"op": "serve_prefill_cut", "client": self.client_id,
                "request": rid, "cut": cut}

    def _serve_decode(self, request: dict) -> dict:
        """One decode round for one request: advance the request's tower
        session by the last sampled token and uplink the (1, 1, cut) frame.
        The frame echoes ``pos``, and the worker checks it against the
        session clock, so a desynchronized driver fails loudly."""
        self._require_serving()
        rid, pos = request["request"], int(request["pos"])
        session = self._serve_sessions.get(rid)
        if session is None:
            raise ValueError(
                f"client {self.client_id}: serve_decode for unknown "
                f"request {rid!r} — prefill first (or the session was "
                "ended/evicted without readmission)")
        # one device-to-host read per decode step
        have = int(session["index"])
        if have != pos:
            raise ValueError(
                f"client {self.client_id}: request {rid!r} decode position "
                f"mismatch — driver says {pos}, tower session is at {have}")
        token = self._tokens(request["token"]).reshape(1)
        cut, session = self.serve_fns.decode(self.params, session, token)
        self._serve_sessions[rid] = session
        return {"op": "serve_cut", "client": self.client_id, "request": rid,
                "pos": pos, "cut": cut}


class SimTransport(Transport):
    """Inline backend: ``submit`` runs the worker on the calling thread and
    queues the response.  Fully deterministic, zero concurrency."""

    def __init__(self, workers: list[TowerWorker]):
        self.workers = workers
        self.num_clients = len(workers)
        self._responses: deque = deque()

    def submit(self, client: int, request: dict) -> None:
        resp = self.workers[client].handle(request)
        if resp is not None and resp["op"] != "bye":
            self._responses.append((client, resp))

    def next_response(self, timeout: Optional[float] = None):
        if not self._responses:
            return None
        return self._responses.popleft()

    def close(self) -> None:
        self._responses.clear()
