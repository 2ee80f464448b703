"""In-process transport: one thread per feature holder, queue-connected.

Every client services its FIFO request queue on its own thread, so tower
forwards for later microbatches (and steps) run while the role-0 caller
merges and backprops earlier ones; PyTorch releases the interpreter lock
inside its kernels, so the overlap is real on a multicore host.

On a card, every thread issues its kernels on the device's default
stream, the same stream as role 0: a payload is put on a queue after the
launches that produce it, so whoever reads it queues its kernels behind
them, and no event or stream synchronisation is needed.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

from repro_torch.transport.base import TowerWorker, Transport

_SHUTDOWN = object()


class InprocTransport(Transport):
    def __init__(self, workers: list[TowerWorker]):
        self.num_clients = len(workers)
        self._requests = [queue.SimpleQueue() for _ in workers]
        self._responses: queue.SimpleQueue = queue.SimpleQueue()
        self._threads = [
            threading.Thread(target=self._serve, args=(k, workers[k]),
                             daemon=True, name=f"splitnn-client{k}")
            for k in range(self.num_clients)
        ]
        self._closed = False
        for t in self._threads:
            t.start()

    def _serve(self, client: int, worker: TowerWorker) -> None:
        while True:
            request = self._requests[client].get()
            if request is _SHUTDOWN:
                return
            try:
                resp = worker.handle(request)
            except Exception as e:  # surface worker crashes to the caller
                self._responses.put(
                    (client, {"op": "error", "client": client,
                              "error": repr(e)}))
                continue
            if resp is not None:
                if resp["op"] == "bye":
                    return
                self._responses.put((client, resp))

    def submit(self, client: int, request: dict) -> None:
        self._requests[client].put(request)

    def next_response(self, timeout: Optional[float] = None):
        """Next ``(client, response)``; a worker's exception comes back as
        a ``RuntimeError`` naming the client."""
        try:
            client, resp = self._responses.get(timeout=timeout)
        except queue.Empty:
            return None
        if resp.get("op") == "error":
            raise RuntimeError(
                f"client {client} worker failed: {resp['error']}")
        return client, resp

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for q in self._requests:
            q.put(_SHUTDOWN)
        for t in self._threads:
            t.join(timeout=30.0)
