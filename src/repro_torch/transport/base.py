"""Transport interface + the feature-holder worker + the inline backend.

``TowerWorker`` is the feature-holder endpoint, transport-agnostic: it owns
this client's tower params (and optionally a local optimizer and feature
source) and serves the ops of :data:`repro_torch.transport.ops.WORKER_OPS`.
Backends differ only in WHERE ``handle`` runs and how requests/responses
move: the inline :class:`SimTransport` here, the threaded
:class:`~repro_torch.transport.inproc.InprocTransport`.  Both keep every
payload a tensor on its device (nothing is pickled).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

import torch

from repro_torch import tree_device
from repro_torch.core import compat
from repro_torch.core import compression as comp_lib
from repro_torch.core import secure_agg
from repro_torch.transport import ops as ops_registry
from repro_torch.tree_util import tree_leaves, tree_map, tree_unflatten


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
    """Role-1/3 endpoint: tower forward/backward, an optional local update,
    and split inference.

    ``tower_fwd(params, feats) -> cut``.  ``feature_fn(step, mb) -> feats``
    lets the worker own its data (regenerated from the shared seed);
    requests may instead carry ``feats`` inline.  ``optimizer`` (the
    port's ``AdamW``: ``init``/``update``) enables local parameter updates
    at ``finish_step`` — tower params never leave the client.
    ``forward_delay_s`` slows this client's forwards (a wall-clock
    straggler).

    Cross-step pipelining (the executor's ``submit_step``/``collect_step``
    driven at window W > 1) means step t+1's forwards arrive BEFORE step
    t's jacobians, so all per-step state is buffered by step:

    * forwards snapshot the params they ran under (``_step_params``) and
      backwards linearize at that snapshot: the jacobian the server returns
      is w.r.t. the snapshot's cut.  The optimizer updates out of place,
      so a later update never writes into a snapshot;
    * gradient accumulators and pending features are per step;
    * a ``finish_step`` carrying ``expected_jacs`` defers its update until
      that many backwards of its step have landed; the completing backward
      then returns the deferred ``step_done``.

    Cuts leave the worker without autograd history (the forward runs under
    ``no_grad``); the backward re-runs the tower forward at the snapshot
    and pulls the jacobian through it with ``torch.autograd.grad`` — the
    vjp the JAX worker takes as ``grad(vdot(tower_fwd(tp, feats), jac))``.

    Secure aggregation (:mod:`repro_torch.core.secure_agg`): the one-time
    ``key_exchange`` op runs in two phases — ``"pub"`` draws an ephemeral
    DH keypair and returns the public value (and the device type the
    worker's masks will be drawn on); ``"finish"`` delivers the full
    public directory (plus ``microbatches``/``scale``) and derives one
    mask seed per peer, locally, then drops the secret: role 0 relays
    public values but never holds a pair's seed.  From then on every
    forward masks its cut AT THE SOURCE with fresh noise of round
    ``step * microbatches + mb``; the worker itself refuses a round that
    does not increase (a replayed or recycled step id would reuse a mask
    and let role 0 difference two uplinks to the raw activation delta).

    Cut compression (``compress`` = ``"topk"`` | ``"int8"``,
    :mod:`repro_torch.core.compression`): every forward compresses its cut
    AT THE SOURCE with error feedback — the residual a step's encode drops
    is kept per microbatch and folded into the next step's payload for the
    same stream position.  Requests arrive FIFO in (step, mb) order on
    every backend, so the carry is step-sequential at any window W; step
    0's residual is zero, which is what lets ``train_split`` verify the
    compressed step 0 against a serial ``protocol_step`` running the same
    codec.  A compressing worker refuses key exchange and relaying (the
    compat matrix: masks do not cancel through codec values, codec frames
    cannot be partial-summed).

    Tree aggregation: ``configure_relay`` makes this worker a RELAY for the
    given child ids.  Instead of uplinking its own cut it accumulates its
    subtree's partial sum: its own forward plus one ``aggregate`` frame per
    child, buffered per (step, mb) in any arrival order across adjacent
    steps, summed in a FIXED order (own cut, then children by configured
    id) once every part landed, and uplinked as one ``tree_cut``.  Masked
    cuts partial-sum the same way (the masks cancel only in role 0's
    full-tree sum).  A relay's backward response carries a ``relay_jac``
    directive: for the additive merges every subtree member's cut gradient
    is the relay's (role 0 pre-applies avg's 1/K), so the router sends the
    same jacobian down to each child.

    ``serve_fns`` is the program's tower serving bundle
    (:class:`~repro_torch.models.split_program.TowerServeFns`); one tower KV
    session per in-flight request, keyed by request id."""

    def __init__(self, client_id: int, tower_fwd: Optional[Callable],
                 tower_params, *, feature_fn: Optional[Callable] = None,
                 optimizer=None, forward_delay_s: float = 0.0,
                 compress: Optional[str] = None,
                 topk_fraction: float = 0.25, serve_fns=None,
                 device: Optional[torch.device] = None):
        if compress is not None and compress not in comp_lib.SCHEMES:
            raise ValueError(
                f"client {client_id}: unknown compression scheme "
                f"{compress!r} (choose from {comp_lib.SCHEMES})")
        self.client_id = client_id
        self.tower_fwd = tower_fwd
        self.params = tower_params
        self.feature_fn = feature_fn
        self.optimizer = optimizer
        self.forward_delay_s = forward_delay_s
        self.compress = compress
        self.topk_fraction = topk_fraction
        self.serve_fns = serve_fns
        self.device = device
        self.opt_state = optimizer.init(tower_params) if optimizer else None
        self._feats: dict = {}  # (step, mb) -> feats awaiting backward
        self._step_params: dict = {}  # step -> params its forwards ran under
        self._grad_sums: dict = {}  # step -> accumulated tower grads
        self._jacs_seen: dict = {}  # step -> backwards processed
        self._pending_finish: dict = {}  # step -> deferred finish request
        self._ef_residual: dict = {}  # mb -> error-feedback residual carry
        self._dh_secret: Optional[int] = None  # ephemeral, key exchange only
        self._secure: Optional[dict] = None  # pair seeds + round derivation
        self._relay_children: tuple = ()  # child ids when acting as a relay
        self._relay_parts: dict = {}  # (step, mb) -> {"self"|child_id: cut}
        self._serve_sessions: dict = {}  # request id -> tower KV session

    def handle(self, request: dict) -> Optional[dict]:
        """Dispatch one request through the op table."""
        op = request["op"]
        spec = ops_registry.WORKER_OPS.get(op)
        if spec is None:
            raise ValueError(f"unknown op {op!r}")
        return getattr(self, spec.handler)(request)

    def _aggregate(self, request: dict) -> Optional[dict]:
        return self._relay_accumulate(request["step"], request["mb"],
                                      request["child"], request["frame"])

    def _serve_end(self, request: dict) -> None:
        # fire-and-forget session teardown: nothing to reply
        self._serve_sessions.pop(request["request"], None)
        return None

    def _get_params(self, request: dict) -> dict:
        return {"op": "params", "client": self.client_id,
                "params": self.params}

    def _shutdown(self, request: dict) -> dict:
        return {"op": "bye", "client": self.client_id}

    # -- training ops -------------------------------------------------------

    def _forward(self, request: dict) -> Optional[dict]:
        if self.forward_delay_s > 0.0:
            time.sleep(self.forward_delay_s)
        step, mb = request["step"], request["mb"]
        feats = request.get("feats")
        if feats is None:
            if self.feature_fn is None:
                raise ValueError(
                    f"client {self.client_id}: no feats in request and no "
                    "feature_fn configured")
            feats = self.feature_fn(step, mb)
        self._feats[(step, mb)] = feats
        params = self._step_params.setdefault(step, self.params)
        with torch.no_grad():
            cut = self.tower_fwd(params, feats)
            if self._secure is not None:
                cut = self._mask(cut, step, mb)
            if self.compress is not None:
                # fold in what the previous step's encode dropped for this
                # stream position, ship the lossy payload, carry the rest
                cut, self._ef_residual[mb] = comp_lib.compress_with_feedback(
                    cut, self._ef_residual.get(mb), self.compress,
                    self.topk_fraction)
        if self._relay_children:
            # this cut is one part of the subtree's partial sum
            return self._relay_accumulate(step, mb, "self", cut)
        return {"op": "cut", "client": self.client_id, "step": step,
                "mb": mb, "cut": cut}

    def _mask(self, cut: torch.Tensor, step: int, mb: int) -> torch.Tensor:
        """Mask at the source: role 0 only ever observes the blinded cut.
        Requests arrive FIFO in (step, mb) order, so a round that does not
        increase is a replayed or recycled step id, and its mask would be
        a reused one."""
        sec = self._secure
        round_idx = step * sec["microbatches"] + mb
        if round_idx <= sec["last_round"]:
            raise ValueError(
                f"client {self.client_id}: mask round {round_idx} "
                f"(step {step}, mb {mb}) already used (last "
                f"{sec['last_round']}) — reusing a mask round leaks the "
                "raw activation delta; drive secure steps with strictly "
                "increasing step ids")
        sec["last_round"] = round_idx
        return secure_agg.mask_payload_with_keys(
            cut, sec["pair_keys"], self.client_id, round_idx, sec["scale"])

    def _configure_relay(self, request: dict) -> dict:
        # the worker's own guard, mirroring the Executor's tree+compress
        # rejection
        compat.check("worker", tree=True, compress=self.compress,
                     context=f"client {self.client_id}")
        self._relay_children = tuple(int(c) for c in request["children"])
        return {"op": "relay_ready", "client": self.client_id}

    def _relay_accumulate(self, step: int, mb: int, part_key,
                          frame: torch.Tensor) -> Optional[dict]:
        parts = self._relay_parts.setdefault((step, mb), {})
        if part_key in parts:
            raise ValueError(
                f"client {self.client_id}: duplicate aggregation part "
                f"{part_key!r} for (step {step}, mb {mb})")
        parts[part_key] = frame
        if len(parts) < 1 + len(self._relay_children):
            return None  # subtree incomplete: parts arrive in any order
        del self._relay_parts[(step, mb)]
        # fixed accumulation order, own cut first, then children by
        # configured id: the same rounding run to run
        total = parts["self"]
        for child in self._relay_children:
            total = total + parts[child]
        return {"op": "tree_cut", "client": self.client_id, "step": step,
                "mb": mb, "cut": total}

    def _mask_device_type(self) -> str:
        dev = self.device or tree_device(self.params)
        return "cpu" if dev is None else torch.device(dev).type

    def _key_exchange(self, request: dict) -> dict:
        # the privacy principal's own guard: a compressing worker must not
        # join a key exchange, whatever the driver says (checked before the
        # phase is read, so a malformed request still rejects loudly)
        compat.check("worker", secure=True, compress=self.compress,
                     context=f"client {self.client_id}")
        phase = request["phase"]
        if phase == "pub":
            self._dh_secret, pub = secure_agg.dh_keypair()
            return {"op": "pub", "client": self.client_id, "pub": pub,
                    "device": self._mask_device_type()}
        if phase == "finish":
            if self._dh_secret is None:
                raise ValueError(
                    f"client {self.client_id}: key_exchange finish before "
                    "pub phase")
            pair_keys = {}
            for other, peer_pub in request["pubs"].items():
                other = int(other)
                if other == self.client_id:
                    continue
                shared = secure_agg.dh_shared(self._dh_secret, peer_pub)
                pair_keys[other] = secure_agg.seed_from_shared(shared)
            self._dh_secret = None  # ephemeral: drop it once keys exist
            self._secure = {
                "pair_keys": pair_keys,
                "microbatches": int(request.get("microbatches", 1)),
                "scale": float(request.get("scale", 1.0)),
                "last_round": -1,  # freshness floor: rounds must increase
            }
            return {"op": "keys_ready", "client": self.client_id}
        raise ValueError(f"unknown key_exchange phase {phase!r}")

    def _backward(self, request: dict) -> dict:
        step, mb = request["step"], request["mb"]
        feats = self._feats.pop((step, mb))
        jac = request["jac"].detach()
        # linearize at the params this step's forwards ran under: the
        # server's jacobian is w.r.t. THAT cut, and at W > 1 a later step's
        # finish may already have moved self.params past the snapshot
        base = self._step_params.get(step, self.params)
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(base)]
        with torch.enable_grad():
            cut = self.tower_fwd(tree_unflatten(base, leaves), feats)
            grads = torch.autograd.grad(cut.to(torch.float32), leaves,
                                        grad_outputs=jac.to(torch.float32),
                                        allow_unused=True)
        # a param the tower does not read gets a zero gradient, as
        # jax.grad gives it
        grad = tree_unflatten(base, [torch.zeros_like(t) if g is None else g
                                     for t, g in zip(leaves, grads)])
        prev = self._grad_sums.get(step)
        self._grad_sums[step] = grad if prev is None else \
            tree_map(torch.add, prev, grad)
        self._jacs_seen[step] = self._jacs_seen.get(step, 0) + 1
        pending = self._pending_finish.get(step)
        if pending is not None and \
                self._jacs_seen[step] >= pending.get("expected_jacs", 0):
            del self._pending_finish[step]
            resp = self._complete_finish(pending)
        else:
            resp = {"op": "grad", "client": self.client_id, "step": step,
                    "mb": mb}
        if self._relay_children:
            # fan the SAME jacobian down the tree; the router turns this
            # directive into one backward per child
            resp["relay_jac"] = {"step": step, "mb": mb, "jac": jac,
                                 "children": list(self._relay_children)}
        return resp

    def _finish_step(self, request: dict) -> Optional[dict]:
        step = request["step"]
        expected = request.get("expected_jacs")
        if expected is not None and self._jacs_seen.get(step, 0) < expected:
            # jacobians for this step still in flight (a non-FIFO backend):
            # defer the update; the completing backward returns step_done
            self._pending_finish[step] = request
            return None
        return self._complete_finish(request)

    def _complete_finish(self, request: dict) -> dict:
        step = request["step"]
        M = request.get("microbatches", 1)
        grad_sum = self._grad_sums.pop(step, None)
        if grad_sum is None:
            avg = tree_map(torch.zeros_like, self.params)
        else:
            avg = tree_map(lambda g: g / M, grad_sum)
        if self.optimizer is not None:
            self.params, self.opt_state = self.optimizer.update(
                self.params, avg, self.opt_state)
        self._step_params.pop(step, None)
        self._jacs_seen.pop(step, None)
        self._feats = {key: v for key, v in self._feats.items()
                       if key[0] != step}
        return {"op": "step_done", "client": self.client_id, "step": step,
                "grad": avg if request.get("collect") else None}

    # -- serving ops --------------------------------------------------------

    def _require_serving(self) -> None:
        if self.serve_fns is None:
            raise ValueError(
                f"client {self.client_id}: no serve_fns configured — split "
                "serving needs the program's tower serving bundle "
                "(SplitProgram.tower_serve_fns; dense family only)")
        # the worker's own guard (it must not trust the driver): serving
        # frames are raw cut tensors
        compat.check("worker", serve=True, secure=self._secure is not None,
                     compress=self.compress,
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
