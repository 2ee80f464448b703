"""Role-0 serving driver: prefill/decode rounds over any transport.

A shared response pump drains ``transport.next_response`` and routes each
frame into its in-flight buffer: a prefill round buffers per-request cut
slices until all K clients reported, a decode round buffers
per-``(request, position)`` one-token frames, so frames of different
requests at different positions interleave freely on the wire.

Every message is Ledger-recorded against the
:class:`~repro_torch.core.protocol.ServeSchedule` specs and reconciles
against ``costs.serve_prefill_bytes`` / ``costs.serve_decode_bytes``.
Cut frames stay tensors on their device: nothing is copied or converted
on the way from the worker to the merge.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.core.protocol import Ledger, ServeSchedule, serve_schedule
from repro_torch.runtime.executor import fast_merge


class ServeDriver:
    """Transport-facing serving half of role 0: ships prompts/tokens down,
    collects cut frames up, merges, and audits bytes.  Model state (slot
    caches, sampling, the cut cache) lives in
    :class:`~repro_torch.serve.split_serve.SplitLMServer`, which drives
    this.  ``use_kernel=False`` merges with the plain version on any
    device (comparison runs)."""

    def __init__(self, transport, *, merge: str, label_holder: int = 0,
                 ledger: Optional[Ledger] = None, timeout_s: float = 120.0,
                 secure: bool = False, compress: Optional[str] = None,
                 tree=None, use_kernel: bool = True):
        self.transport = transport
        self.num_clients = transport.num_clients
        self.merge = merge
        self.use_kernel = use_kernel
        # training-path overlays are passed through to serve_schedule,
        # whose compat gate rejects them
        self.schedule: ServeSchedule = serve_schedule(
            self.num_clients, label_holder, secure=secure,
            compress=compress, tree=tree)
        self.ledger = ledger if ledger is not None else Ledger()
        self.timeout_s = timeout_s
        self._prefill_buf: dict = {}  # request -> {client: cut (1, S, D)}
        self._decode_buf: dict = {}  # (request, pos) -> {client: cut}

    # -- the shared response pump -------------------------------------------

    def _pump(self, timeout: Optional[float]) -> bool:
        """Route one transport response into its in-flight buffer; returns
        False on timeout."""
        got = self.transport.next_response(timeout)
        if got is None:
            return False
        client, resp = got
        op = resp.get("op")
        if op == "serve_prefill_cut":
            buf = self._prefill_buf.setdefault(resp["request"], {})
        elif op == "serve_cut":
            buf = self._decode_buf.setdefault(
                (resp["request"], int(resp["pos"])), {})
        else:
            raise RuntimeError(
                f"serve driver: unexpected response op {op!r} from client "
                f"{client} — training and serving frames must not share a "
                "driver instance")
        if client in buf:
            raise RuntimeError(
                f"serve driver: duplicate cut frame from client {client} "
                f"for {resp.get('request')!r}")
        buf[client] = resp["cut"]
        return True

    def _drain_until(self, done) -> None:
        deadline = time.monotonic() + self.timeout_s
        while not done():
            remaining = deadline - time.monotonic()
            if remaining <= 0.0:
                raise TimeoutError(
                    f"serve driver: clients did not answer within "
                    f"{self.timeout_s:.0f}s")
            if not self._pump(min(remaining, 0.25)):
                # SimTransport returns at once when idle — don't hot-spin
                time.sleep(0.01)

    def _merge(self, cuts: dict) -> torch.Tensor:
        return fast_merge(
            torch.stack([cuts[k] for k in range(self.num_clients)]),
            self.merge, use_kernel=self.use_kernel)

    # -- rounds --------------------------------------------------------------

    def prefill(self, rid, prompt: torch.Tensor, cache_len: int) -> torch.Tensor:
        """One request's prefill round: ship the prompt ids to every
        feature holder, collect all K full-prompt cut slices, merge.
        Returns the merged cut activation (1, S, d)."""
        prompt = prompt.reshape(-1)
        S = int(prompt.shape[0])
        for k in range(self.num_clients):
            self.transport.submit(k, {
                "op": "serve_prefill", "request": rid, "tokens": prompt,
                "cache_len": int(cache_len),
            })
            # the wire carries int32 ids, whatever the host tensor's type
            self.ledger.record_spec_bytes(self.schedule.prompts[k], S * 4)
        self._drain_until(
            lambda: len(self._prefill_buf.get(rid, ())) == self.num_clients)
        cuts = self._prefill_buf.pop(rid)
        for k in range(self.num_clients):
            self.ledger.record_spec(self.schedule.prefill_cuts[k], cuts[k])
        return self._merge(cuts)

    def decode_round(self, entries: list) -> dict:
        """One decode round for a batch of in-flight requests.

        ``entries`` is ``[(rid, token, pos), ...]`` for the ACTIVE requests.
        All K * len(entries) token frames are submitted before any cut
        frame is collected.  Returns ``{rid: merged (1, 1, d)}``."""
        for rid, token, pos in entries:
            for k in range(self.num_clients):
                self.transport.submit(k, {
                    "op": "serve_decode", "request": rid,
                    "token": int(token), "pos": int(pos),
                })
                self.ledger.record_spec_bytes(self.schedule.tokens[k], 4)
        keys = [(rid, int(pos)) for rid, _, pos in entries]
        self._drain_until(lambda: all(
            len(self._decode_buf.get(key, ())) == self.num_clients
            for key in keys))
        merged = {}
        for rid, _, pos in entries:
            cuts = self._decode_buf.pop((rid, int(pos)))
            for k in range(self.num_clients):
                self.ledger.record_spec(self.schedule.cuts[k], cuts[k])
            merged[rid] = self._merge(cuts)
        return merged

    def end_session(self, rid) -> None:
        """Retire a request at every feature holder (fire-and-forget)."""
        for k in range(self.num_clients):
            self.transport.submit(k, {"op": "serve_end", "request": rid})
