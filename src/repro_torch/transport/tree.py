"""Tree-aggregation routing over any star-physical transport.

The three backends are star-shaped: role 0 is the only caller and every
response comes home to it.  :class:`TreeRouter` overlays an
:class:`~repro_torch.runtime.topology.AggTree` on that star: it forwards a
client's cut frame to its RELAY PARENT (as an ``aggregate`` request)
instead of delivering it, delivers only the ``min(F, K)`` combined
top-level frames to the executor, and turns a relay's ``relay_jac``
backward directive into one ``backward`` per child.  The executor above
sees a plain :class:`~repro_torch.transport.base.Transport` whose
per-step response volume is O(F), and the workers below see ordinary
star requests.

Routed hops cross the physical star twice (child -> role 0 -> parent);
on a real deployment relays would talk edge to edge.  What the overlay
reproduces is role 0's side: it merges and fans out O(F) frames per
microbatch instead of O(K), the rest of the merge runs on the relays, and
the Ledger (which records the LOGICAL per-edge schedule) audits the bytes
a real tree deployment would move.

Routing runs on a pump thread for the threaded and process backends (so
forwarding never blocks the executor's submit and collect halves) and
inline for :class:`~repro_torch.transport.base.SimTransport` (so the
serial numerics stay deterministic).  A worker error raised by the base
transport's ``next_response`` is re-raised from this router's.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

from repro_torch.transport.base import SimTransport, Transport

_RAISE = "__tree_router_raise__"


class TreeRouter(Transport):
    def __init__(self, base: Transport, tree):
        if tree.num_clients != base.num_clients:
            raise ValueError(
                f"tree covers {tree.num_clients} clients, transport has "
                f"{base.num_clients}")
        self.base = base
        self.tree = tree
        self.num_clients = base.num_clients
        self._closed = False
        self._inline = isinstance(base, SimTransport)
        if self._inline:
            self._delivered: list = []
        else:
            self._out: queue.SimpleQueue = queue.SimpleQueue()
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._pump, daemon=True, name="splitnn-tree-router")
            self._thread.start()

    # -- transport contract ---------------------------------------------------

    def submit(self, client: int, request: dict) -> None:
        self.base.submit(client, request)
        if self._inline:
            self._drain_inline()

    def next_response(self, timeout: Optional[float] = None):
        if self._inline:
            return self._delivered.pop(0) if self._delivered else None
        try:
            client, resp = self._out.get(timeout=timeout)
        except queue.Empty:
            return None
        if client == _RAISE:
            raise resp
        return client, resp

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if not self._inline:
            # stop routing BEFORE closing the base: the pump must not poll
            # sockets or queues that close() is tearing down
            self._stop.set()
            self._thread.join(timeout=5.0)
        self.base.close()

    # -- routing --------------------------------------------------------------

    def _route(self, client: int, resp: dict) -> list:
        """Route one base response; returns the (client, response) pairs to
        deliver to the executor (none for a consumed frame)."""
        relay_jac = resp.pop("relay_jac", None)
        if relay_jac is not None:
            # a relay's backward fans the SAME jacobian to each child
            for child in relay_jac["children"]:
                self.base.submit(child, {
                    "op": "backward", "step": relay_jac["step"],
                    "mb": relay_jac["mb"], "jac": relay_jac["jac"]})
        if resp["op"] in ("cut", "tree_cut"):
            parent = self.tree.parent(client)
            if parent is None:
                # a top-level frame: the executor takes it as a plain cut
                # (its payload is the whole subtree's partial sum)
                return [(client, {**resp, "op": "cut"})]
            self.base.submit(parent, {
                "op": "aggregate", "step": resp["step"], "mb": resp["mb"],
                "child": client, "frame": resp["cut"]})
            return []  # consumed: the parent emits the combined frame
        return [(client, resp)]

    def _drain_inline(self) -> None:
        # SimTransport runs handlers inside submit, so the routed submits
        # above queue follow-up responses that this loop then consumes
        while True:
            item = self.base.next_response(0)
            if item is None:
                return
            self._delivered.extend(self._route(*item))

    def _pump(self) -> None:
        while not self._stop.is_set():
            try:
                item = self.base.next_response(timeout=0.1)
            except Exception as exc:  # surface worker errors to the caller
                self._out.put((_RAISE, exc))
                continue
            if item is None:
                continue
            try:
                for deliverable in self._route(*item):
                    self._out.put(deliverable)
            except Exception as exc:
                self._out.put((_RAISE, exc))
