"""Executor: drive the training schedule over any transport.

The single execution path behind ``protocol_step`` (serial),
``engine.pipelined_step`` (microbatch pipelining / no-wait over the
simulated clock) and the split-executing train loop: one role-0 driver
that walks ``step_schedule``, records every message in a per-step
:class:`~repro_torch.core.protocol.Ledger`, merges the cut activations
(EMA-imputing no-wait misses), backprops the server network and returns
per-client jacobians — over a :class:`~repro_torch.transport.Transport`.

The step is split into two halves so a driver can keep several steps in
flight (:class:`~repro_torch.runtime.pipeline.StepPipeline`):

* :meth:`Executor.submit_step` ships every tower-forward request for one
  step and registers its in-flight state (its own Ledger, cut buffers,
  deadline bookkeeping);
* :meth:`Executor.collect_step` gathers the OLDEST in-flight step's cuts,
  runs the role-0 merge/forward/backward per microbatch, fans the
  jacobians out, and barriers on the workers' ``step_done`` acks.

One shared pump routes every transport response to its step's buffers by
``(step, microbatch)``, so cuts of step t+1 arriving while step t is
being collected land where they belong.  At window W > 1 the towers train
on delayed gradients (``ExecReport.staleness``); W = 1 is the serial
semantics.

Drop policies, as in the JAX package:

* ``"neutral"`` — serial protocol semantics: the plain merge masks a
  client to its strategy's neutral element (``merge_mask``); jacobians
  still flow to every client.  ``protocol_step``'s policy.
* ``"fused"`` — everyone is live and :func:`fast_merge` merges the full
  stack: the forward merge kernel on the card, and autograd's backward
  through it is the backward merge kernel
  (:class:`~repro_torch.kernels.ops.MergePool`).
* ``"impute"`` — no-wait: missing seats are filled from the per-client
  EMA (:mod:`repro_torch.core.straggler`) inside the graph the server
  backward differentiates, the filled stack goes through
  :func:`fast_merge` (both merge kernels on the card), and only live
  clients get a jacobian.

Liveness comes either from a predetermined matrix (the simulated clock of
``engine.simulate_pipelined``: every payload still flows, the clock just
decides who made the merge) or, in ``"nowait"`` mode over a real
transport, from wall-clock deadlines driven by the
:class:`~repro_torch.runtime.deadline.AdaptiveDeadline` arrival EWMAs.

The three wire overlays, as in the JAX package (unsound compositions
reject through the compat matrix, with its words):

* secure aggregation (``secure_agg=True``): :meth:`Executor.setup_secure`
  runs the one-time key exchange, after which the workers mask every cut
  at the source and role 0 merges MASKED cuts — the pairwise masks cancel
  in the sum/avg merge;
* cut compression (``compress="topk"|"int8"``): the workers compress
  their uplinks at the source and this side compresses the K jacobian
  downlinks, each stream with its own error-feedback residual; the Ledger
  records the codec's wire bytes for both directions;
* aggregation trees (``agg_tree=AggTree(K, fanout=F)``): the transport is
  wrapped in a :class:`~repro_torch.transport.tree.TreeRouter`, relays
  partial-sum their subtrees, and role 0 merges the ``min(F, K)``
  top-level frames with ``fast_merge(..., "sum")`` (avg divides the
  full-tree sum by K) and fans ONE jacobian to each top-level client.

A program with an auxiliary loss (``server_aux``: the moe router's
load-balance term) returns ``(logits, aux)`` from ``server_fwd``; each
microbatch's loss is ``loss_fn(logits) + aux``, its aux scalar rides the
schedule's role-0 -> role-3 ``aux_loss`` slot, and the result's ``aux``
is the mean over the microbatches.  A program with
``server_takes_batch`` (the audio decoder's teacher-forcing tokens) gets
the role-0 batch context, microbatch-sliced, as ``server_fwd``'s third
argument; the context may be any batch-major tree.  A program
``merge_fn`` (the vlm sequence concatenation) merges a per-client list
of cuts of different shapes in place of the stack, and the server's
backward hands each client the gradient of its own cut; it needs every
cut (a barrier mode) and composes with none of the wire overlays
(the compat matrix).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.core import compat
from repro_torch.core import compression as comp_lib
from repro_torch.core import merge as merge_lib
from repro_torch.core import straggler as straggler_lib
from repro_torch.core.merge import collective_bytes_per_merge
from repro_torch.core.protocol import Ledger, step_schedule
from repro_torch.core.secure_agg import KEYX_GROUP_BYTES
from repro_torch.kernels import ops
from repro_torch.runtime.deadline import AdaptiveDeadline
from repro_torch.transport.tree import TreeRouter
from repro_torch.tree_util import tree_leaves, tree_map, tree_unflatten

DROP_POLICIES = ("neutral", "fused", "impute")

# retired (step, mb) first-arrival timestamps kept around so a no-wait
# straggler's cut landing after its step was collected still feeds the
# deadline EWMA (that is how a recovered client re-opens the window)
_RETIRED_FIRST_T_KEEP = 64


def fast_merge(stacked: torch.Tensor, strategy: str, *,
               use_kernel: bool = True) -> torch.Tensor:
    """merge_pool for every strategy — the fused kernel on CUDA (reductions
    AND the gather-concat), the plain version on the CPU; differentiable
    on both (the backward kernel on CUDA).

    The kernel is (K, B, D)-shaped; LM cut stacks arrive as (K, B, S, D),
    so extra middle dims are flattened around the call and restored after
    (rows are independent in every merge, so this is exact)."""
    if stacked.ndim > 3:
        K, D = stacked.shape[0], stacked.shape[-1]
        out = ops.merge_pool(stacked.reshape(K, -1, D), strategy=strategy,
                             use_kernel=use_kernel)
        out_d = K * D if strategy == "concat" else D
        return out.reshape(stacked.shape[1:-1] + (out_d,))
    return ops.merge_pool(stacked, strategy=strategy, use_kernel=use_kernel)


def tree_mean(trees: list):
    """The leafwise mean; one tree is its own mean (no copy of a large
    tree's gradients)."""
    if len(trees) == 1:
        return trees[0]
    return tree_map(lambda *leaves: sum(leaves) / len(leaves), *trees)


@dataclass
class ExecReport:
    """Measured (wall-clock) sibling of ``engine.SimReport`` — the same
    field contract, but ``step_time_s`` is real elapsed time on a real
    transport and ``live`` reflects deadlines that actually fired."""

    mode: str
    transport: str
    step_time_s: float
    microbatches: int
    live: list[list[float]]  # (M, K) — 1.0 = client's cut made the merge
    misses_per_client: list[int]
    cut_bytes_per_client: int
    collective_bytes_per_client: int
    deadline_s: Optional[float] = None  # last deadline used (nowait)
    # steps submitted after this one before it was collected: the tower
    # params' delayed-gradient lag (0 = serial semantics, W-1 at window W)
    staleness: int = 0

    @property
    def total_misses(self) -> int:
        return sum(self.misses_per_client)


@dataclass
class ExecutionResult:
    loss: torch.Tensor
    tower_grads: Optional[list]
    server_grads: object
    ledger: Ledger
    report: object  # SimReport (simulated liveness) or ExecReport (measured)
    ema_state: Optional[dict] = None  # the no-wait EMA, detached
    # the mean server-side auxiliary loss shipped role 0 -> role 3
    # (server_aux: the moe router's load-balance term); None otherwise
    aux: Optional[torch.Tensor] = None
    step: int = 0  # which training step this result belongs to


@dataclass
class _InflightStep:
    """Role-0-side state of one submitted-but-uncollected step."""

    step: int
    labels: torch.Tensor  # batch-major role-3 context
    mbsz: int
    ledger: Ledger
    submit_t: float
    cuts: dict = field(default_factory=dict)  # mb -> {client: cut}
    first_t: dict = field(default_factory=dict)  # mb -> first drain time
    merged: set = field(default_factory=set)  # mbs already merged
    sent_jacs: list = field(default_factory=list)  # per-client bwd count
    done: list = field(default_factory=list)  # per-client step_done
    grads: list = field(default_factory=list)  # per-client final tower grads


class Executor:
    """Role-0 server driving training steps over a transport.

    One training step is :meth:`submit_step` (ship the tower forwards)
    followed by :meth:`collect_step` (merge, server backward, jacobian
    fan-out, step barrier); :meth:`run_step` runs both back-to-back.

    ``server_fwd(server_params, merged) -> logits`` (``(logits, aux)``
    with ``server_aux``; ``server_fwd(server_params, merged, ctx)`` with
    ``server_takes_batch``), ``loss_fn(logits, ctx) -> scalar`` and
    ``merge_fn(cuts, live_mask) -> merged`` (or None) come from the
    program.  The server backward is
    ``torch.autograd.grad`` of the loss over the server param leaves and
    the stacked cuts, both fresh leaves made from detached tensors, so it
    never runs back into a tower's graph.

    ``deadline`` (no-wait over a real transport): ``None`` bootstraps an
    :class:`~repro_torch.runtime.deadline.AdaptiveDeadline` from the first
    full barrier, a float is a static grace window after a microbatch's
    first cut, and a controller is used as given.  ``ema_decay`` is the
    imputation EMA's decay.

    ``secure_agg``/``secure_scale`` (the masks' standard deviation),
    ``compress``/``topk_fraction`` and ``agg_tree`` are the wire overlays
    of the module docstring.  Under a tree ``self.transport`` is the
    :class:`~repro_torch.transport.tree.TreeRouter`; callers that close
    the transport close THAT (it stops its pump before the base)."""

    def __init__(self, transport, server_fwd: Callable, loss_fn: Callable,
                 merge: str, *, mode: str = "pipelined", microbatches: int = 1,
                 label_holder: int = 0, drop_policy: Optional[str] = None,
                 ema_decay: float = 0.95, deadline=None,
                 server_takes_batch: bool = False, server_aux: bool = False,
                 merge_fn: Optional[Callable] = None,
                 secure_agg: bool = False, secure_scale: float = 1.0,
                 compress: Optional[str] = None, topk_fraction: float = 0.25,
                 agg_tree=None):
        if mode not in ("serial", "pipelined", "nowait"):
            raise ValueError(f"mode must be serial|pipelined|nowait, got {mode!r}")
        if drop_policy is None:
            drop_policy = "impute" if mode == "nowait" else "fused"
        if drop_policy not in DROP_POLICIES:
            raise ValueError(f"drop_policy must be one of {DROP_POLICIES}")
        if compress is not None and compress not in comp_lib.SCHEMES:
            raise ValueError(
                f"unknown compression scheme {compress!r} (choose from "
                f"{comp_lib.SCHEMES})")
        compat.check(
            "executor", secure=secure_agg, compress=compress, tree=agg_tree,
            merge=merge, merge_fn=merge_fn,
            nowait=mode == "nowait" or drop_policy != "fused",
            impute=drop_policy == "impute",
            context=f"Executor(mode={mode!r}, drop_policy={drop_policy!r})")
        self.server_takes_batch = server_takes_batch
        self.server_aux = server_aux
        self.merge_fn = merge_fn
        if agg_tree is not None:
            if agg_tree.num_clients != transport.num_clients:
                raise ValueError(
                    f"tree covers {agg_tree.num_clients} clients, transport "
                    f"has {transport.num_clients}")
            if not isinstance(transport, TreeRouter):
                transport = TreeRouter(transport, agg_tree)
        self.agg_tree = agg_tree
        self._tree_ready = agg_tree is None or not agg_tree.relays
        self.transport = transport
        self.server_fwd = server_fwd
        self.loss_fn = loss_fn
        self.merge = merge
        self.mode = mode
        self.microbatches = microbatches
        self.label_holder = label_holder
        self.drop_policy = drop_policy
        self.ema_decay = ema_decay
        self.secure_agg = secure_agg
        self.secure_scale = secure_scale
        self.compress = compress
        self.topk_fraction = topk_fraction
        # error-feedback residuals of the jacobian downlinks, keyed by
        # (client, mb): steps are collected oldest first, so each stream
        # position's carry advances one step at a time at any window W
        self._jac_residuals: dict = {}
        self._secure_ready = False
        self._max_secure_step = -1  # highest masked step id (freshness)
        # the one-time key exchange's audit (keyx_pub / keyx_bcast tags)
        self.keyx_ledger = Ledger()
        # deadline: None -> bootstrap an AdaptiveDeadline from the first
        # full barrier; float -> static window; AdaptiveDeadline -> as given
        if deadline is None:
            self.deadline = AdaptiveDeadline(transport.num_clients)
            self.static_deadline_s = None
        elif isinstance(deadline, AdaptiveDeadline):
            self.deadline = deadline
            self.static_deadline_s = None
        else:
            self.deadline = None
            self.static_deadline_s = float(deadline)
        self._schedule = step_schedule(transport.num_clients, label_holder,
                                       secure=secure_agg, compress=compress,
                                       tree=agg_tree)
        self._inflight: dict[int, _InflightStep] = {}  # insertion-ordered
        self._retired_first_t: dict[tuple[int, int], float] = {}

    def _idle_error(self, phase: str, detail: str = "") -> RuntimeError:
        msg = f"transport idle {phase}"
        if detail:
            msg += f" ({detail})"
        if self._inflight:
            msg += f" [steps in flight: {list(self._inflight)}]"
        return RuntimeError(msg)

    def _await(self, op: str, count: int, phase: str, timeout_s: float):
        """Yield the next ``count`` responses of a one-time setup round,
        each of op ``op``."""
        for got_n in range(count):
            got = self.transport.next_response(timeout_s)
            if got is None:
                raise self._idle_error(phase, f"{got_n}/{count} in")
            k, resp = got
            if resp["op"] != op:
                raise RuntimeError(
                    f"unexpected {resp['op']!r} from client {k} {phase}")
            yield k, resp

    # -- secure-aggregation setup (one-time key-exchange round) ---------------

    def setup_secure(self, *, timeout_s: float = 120.0) -> Ledger:
        """Run the in-protocol pairwise key agreement: gather each client's
        public value, relay the full directory back down, and barrier on
        every ``keys_ready``.  Role 0 only handles public group elements;
        each pair's mask seed is derived at the two clients.  Recorded in
        :attr:`keyx_ledger` (``keyx_pub[k]`` / ``keyx_bcast[k]``).  Refuses a
        federation whose workers draw their masks on different device types
        (CPU and CUDA generators differ, and the masks would not cancel).
        Idempotent; runs on the first :meth:`submit_step` if not called."""
        if not self.secure_agg:
            raise RuntimeError("setup_secure on a non-secure Executor "
                               "(construct with secure_agg=True)")
        if self._secure_ready:
            return self.keyx_ledger
        if self._inflight:
            raise RuntimeError("key exchange must precede the first step")
        transport, K = self.transport, self.transport.num_clients
        schedule = self._schedule
        for spec in schedule.key_pubs:
            transport.submit(spec.client, {"op": "key_exchange",
                                           "phase": "pub"})
        pubs: dict[int, int] = {}
        devices: dict[int, str] = {}
        for _, resp in self._await("pub", K, "during key exchange",
                                   timeout_s):
            client = int(resp["client"])
            pubs[client] = resp["pub"]
            devices[client] = resp["device"]
            self.keyx_ledger.record_spec_bytes(schedule.key_pubs[client],
                                               KEYX_GROUP_BYTES)
        if len(set(devices.values())) > 1:
            raise RuntimeError(
                "secure aggregation needs every client to draw its masks on "
                f"one device type, got {devices}: CPU and CUDA generators "
                "give different noise from one seed, so the pairwise masks "
                "would not cancel")
        for spec in schedule.key_bcasts:
            transport.submit(spec.client, {
                "op": "key_exchange", "phase": "finish", "pubs": pubs,
                "microbatches": self.microbatches,
                "scale": self.secure_scale})
            self.keyx_ledger.record_spec_bytes(spec, K * KEYX_GROUP_BYTES)
        for _ in self._await("keys_ready", K, "awaiting keys_ready",
                             timeout_s):
            pass
        self._secure_ready = True
        return self.keyx_ledger

    # -- tree setup (one-time relay configuration round) ----------------------

    def setup_tree(self, *, timeout_s: float = 120.0) -> None:
        """Ship each relay its child ids (one-time ``configure_relay``) and
        barrier on every ``relay_ready``.  Idempotent; runs on the first
        :meth:`submit_step`.  A tree with no relays is a no-op."""
        if self.agg_tree is None:
            raise RuntimeError("setup_tree on a non-tree Executor "
                               "(construct with agg_tree=AggTree(...))")
        if self._tree_ready:
            return
        if self._inflight:
            raise RuntimeError("relay configuration must precede the first "
                               "step")
        relays = self.agg_tree.relays
        for r in relays:
            self.transport.submit(r, {
                "op": "configure_relay",
                "children": list(self.agg_tree.children(r))})
        for _ in self._await("relay_ready", len(relays),
                             "during relay configuration", timeout_s):
            pass
        self._tree_ready = True

    # -- step halves ----------------------------------------------------------

    @property
    def inflight_steps(self) -> list[int]:
        """Steps submitted but not yet collected, oldest first."""
        return list(self._inflight)

    def submit_step(self, step: int, labels: torch.Tensor, *,
                    features: Optional[list] = None,
                    ledger: Optional[Ledger] = None) -> None:
        """Ship every tower-forward request of ``step`` and register its
        in-flight state.  ``labels`` is the role-0/3 context: the labels,
        or any batch-major tree (a program's ``batch_ctx``).
        ``features`` (per-client tensors, batch-major) ride the requests;
        omit them when workers own a ``feature_fn``.  Each step audits its
        bytes in its OWN Ledger."""
        transport, K, M = (self.transport, self.transport.num_clients,
                           self.microbatches)
        if step in self._inflight:
            raise ValueError(f"step {step} already in flight")
        if not self._tree_ready:
            self.setup_tree()
        if self.secure_agg:
            if not self._secure_ready:
                self.setup_secure()
            # mask freshness: the round derives from the step id, so a
            # recycled id would reuse masks.  The workers enforce it too;
            # this is the early error naming the API misuse
            if step <= self._max_secure_step:
                raise ValueError(
                    f"secure aggregation needs strictly increasing step ids "
                    f"(got {step} after {self._max_secure_step}): the mask "
                    "round index derives from the step, and a reused round "
                    "leaks the raw activation delta — pass step= explicitly "
                    "when looping run_step")
            self._max_secure_step = step
        B = tree_leaves(labels)[0].shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches={M}")
        st = _InflightStep(
            step=step, labels=labels, mbsz=B // M,
            ledger=ledger if ledger is not None else Ledger(),
            submit_t=time.monotonic(),
            sent_jacs=[0] * K, done=[False] * K, grads=[None] * K)
        self._inflight[step] = st
        for m in range(M):
            for spec in self._schedule.cuts:
                req = {"op": "forward", "step": step, "mb": m}
                if features is not None:
                    sl = slice(m * st.mbsz, (m + 1) * st.mbsz)
                    req["feats"] = features[spec.client][sl]
                transport.submit(spec.client, req)

    def collect_step(self, server_params, *, liveness=None, merge_mask=None,
                     ema_state: Optional[dict] = None,
                     collect_grads: bool = True,
                     report=None) -> ExecutionResult:
        """Collect the OLDEST in-flight step: merge its microbatches, run the
        role-0 forward/backward, fan jacobians out, barrier on
        ``step_done``.

        ``liveness`` is an (M, K) 0/1 matrix from a simulated clock;
        without it, ``"nowait"`` measures liveness against wall-clock
        deadlines and other modes barrier on all K cuts.  ``ema_state`` is
        the imputation state the ``"impute"`` policy threads from step to
        step (made on the first merge when None).  A ``report`` passed in
        (the simulated clock's) is returned untouched; otherwise a measured
        :class:`ExecReport` is built."""
        if not self._inflight:
            raise RuntimeError("no in-flight step to collect "
                               "(call submit_step first)")
        tree = self.agg_tree
        if tree is not None and (liveness is not None
                                 or merge_mask is not None):
            raise ValueError(
                "tree aggregation is barrier-only: per-client liveness / "
                "merge_mask cannot be applied to a relay's combined frame "
                "(the partial sum already folded every subtree member in)")
        st = next(iter(self._inflight.values()))
        transport, K, M = (self.transport, self.transport.num_clients,
                           self.microbatches)
        schedule = self._schedule
        staleness = sum(1 for s in self._inflight if s > st.step)
        mbsz = st.mbsz
        server_leaves = tree_leaves(server_params)

        losses, aux_acc, server_grad_acc, live_matrix = [], [], [], []
        misses = [0] * K
        last_deadline: Optional[float] = self.static_deadline_s
        cuts_in = None
        for m in range(M):
            live_row, deadline_used = self._gather(st, m, liveness)
            if deadline_used is not None:
                last_deadline = deadline_used
            for k in range(K):
                if live_row[k] <= 0:
                    misses[k] += 1
            live_matrix.append(live_row)
            st.merged.add(m)

            arrived = st.cuts.pop(m, {})
            if tree is not None:
                # one frame per top-level client: its subtree's partial sum
                cuts_in = torch.stack([arrived[t] for t in tree.top_level])
            elif self.merge_fn is not None:
                # cuts of different shapes: no stack to zero-fill, and the
                # barrier modes guarantee every cut arrived
                if len(arrived) < K:
                    raise RuntimeError(
                        f"program merge needs every cut; microbatch {m} is "
                        f"missing clients "
                        f"{sorted(set(range(K)) - set(arrived))}")
                cuts_in = [arrived[k] for k in range(K)]
            else:
                proto = next(iter(arrived.values()))
                cuts_in = torch.stack([arrived[k] if k in arrived
                                       else torch.zeros_like(proto)
                                       for k in range(K)])
            if self.drop_policy == "impute" and ema_state is None:
                ema_state = {
                    "ema": torch.zeros((K, cuts_in.shape[-1]),
                                       dtype=torch.float32,
                                       device=cuts_in.device),
                    "initialized": torch.zeros((K,), dtype=torch.float32,
                                               device=cuts_in.device)}
            labels_m = tree_map(lambda a: a[m * mbsz:(m + 1) * mbsz],
                                st.labels)

            # fresh leaves over the same storage: the graph starts here
            leaves = [t.detach().requires_grad_(True) for t in server_leaves]
            cuts = [c.requires_grad_(True) for c in cuts_in] \
                if self.merge_fn is not None else cuts_in.requires_grad_(True)
            with torch.enable_grad():
                if tree is not None:
                    # the final merge over the top-level partial sums; avg
                    # is the full-tree sum over K, not over len(top_level)
                    merged = fast_merge(cuts, "sum")
                    if self.merge == "avg":
                        merged = merged / K
                elif self.merge_fn is not None:
                    merged = self.merge_fn(
                        cuts, merge_mask if self.drop_policy == "neutral"
                        else None)
                elif self.drop_policy == "impute":
                    # inside the differentiated graph: a filled seat gets
                    # zero gradient, a live seat the merge's backward
                    live_vec = torch.tensor(live_row, dtype=torch.float32,
                                            device=cuts_in.device)
                    imputed, ema_state = straggler_lib.impute_stack(
                        cuts, live_vec, ema_state, decay=self.ema_decay)
                    ema_state = straggler_lib.detach_state(ema_state)
                    merged = fast_merge(imputed, self.merge)
                elif self.drop_policy == "neutral":
                    merged = merge_lib.merge_stacked(cuts, self.merge,
                                                     live_mask=merge_mask)
                else:
                    merged = fast_merge(cuts, self.merge)
                server_p = tree_unflatten(server_params, leaves)
                out = self.server_fwd(server_p, merged, labels_m) \
                    if self.server_takes_batch else \
                    self.server_fwd(server_p, merged)
                if self.server_aux:
                    logits, aux_m = out
                    loss_m = self.loss_fn(logits, labels_m) + aux_m
                else:
                    logits = out
                    loss_m = self.loss_fn(logits, labels_m)
            # a server leaf that the forward does not read (an untied
            # model's input table: the towers embed from their own
            # slices) gets a zero gradient, as jax.grad gives it
            wrt = leaves + (cuts if self.merge_fn is not None else [cuts])
            grads = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(wrt, torch.autograd.grad(
                         loss_m, wrt, allow_unused=True))]
            # the ledger needs the head output's size only: the logits are
            # not kept past this microbatch
            head_bytes = logits.numel() * logits.element_size()
            del logits, merged, out
            st.ledger.record_spec_bytes(schedule.head_out, head_bytes)
            if self.server_aux:
                # the aux scalar rides the role-0 -> role-3 loss exchange
                st.ledger.record_spec(schedule.aux, aux_m)
                aux_acc.append(aux_m.detach())
            st.ledger.record_spec_bytes(schedule.head_jac, head_bytes)
            # the merge's backward split back per client: one slice of the
            # stack's gradient each, or each cut's own (merge_fn)
            cut_grads = grads[len(leaves):] if self.merge_fn is not None \
                else grads[-1]
            if tree is not None:
                # ONE backward per top-level client; relays forward the same
                # jacobian down (avg's 1/K is already inside cut_grads).  The
                # ledger records every logical tree edge, and sent_jacs
                # counts the backward each member gets through the router
                for i, t in enumerate(tree.top_level):
                    jac_out = cut_grads[i]
                    for member in tree.subtree(t):
                        st.ledger.record_spec(schedule.jacs[member], jac_out)
                        st.sent_jacs[member] += 1
                    transport.submit(t, {"op": "backward", "step": st.step,
                                         "mb": m, "jac": jac_out})
            else:
                for spec in schedule.jacs:
                    k = spec.client
                    # serial/neutral semantics: jacobians flow to every
                    # client; no-wait: a missed deadline skips this
                    # microbatch's update
                    if self.drop_policy == "neutral" or live_row[k] > 0:
                        jac_out = cut_grads[k]
                        if self.compress is not None:
                            # the downlink's codec with error feedback: what
                            # this encode drops rides into the next step's
                            # jacobian for the same (client, mb) stream
                            res_key = (k, m)
                            jac_out, self._jac_residuals[res_key] = \
                                comp_lib.compress_with_feedback(
                                    jac_out, self._jac_residuals.get(res_key),
                                    self.compress, self.topk_fraction)
                            st.ledger.record_spec_bytes(
                                spec, comp_lib.payload_bytes(
                                    jac_out, self.compress,
                                    self.topk_fraction))
                        else:
                            st.ledger.record_spec(spec, jac_out)
                        st.sent_jacs[k] += 1
                        transport.submit(k, {"op": "backward",
                                             "step": st.step, "mb": m,
                                             "jac": jac_out})
            losses.append(loss_m.detach())
            server_grad_acc.append(tree_unflatten(
                server_params, list(grads[:len(leaves)])))

        for k in range(K):
            transport.submit(k, {
                "op": "finish_step", "step": st.step, "microbatches": M,
                "collect": collect_grads, "expected_jacs": st.sent_jacs[k]})
        while not all(st.done):
            if not self._pump(None):
                raise self._idle_error(
                    "awaiting step_done",
                    f"step {st.step}: {sum(st.done)}/{K} workers done")
        self._retire(st)

        loss = sum(losses) / M
        aux = sum(aux_acc) / M if aux_acc else None
        server_grads = tree_mean(server_grad_acc)
        tower_grads = list(st.grads) if collect_grads else None
        if report is None:
            report = self._build_report(
                time.monotonic() - st.submit_t, live_matrix, misses,
                st.ledger, cuts_in, last_deadline, staleness)
        return ExecutionResult(loss, tower_grads, server_grads, st.ledger,
                               report, ema_state, aux, step=st.step)

    def run_step(self, server_params, labels, *, step: int = 0,
                 features: Optional[list] = None, liveness=None,
                 merge_mask=None, ema_state: Optional[dict] = None,
                 ledger: Optional[Ledger] = None, collect_grads: bool = True,
                 report=None) -> ExecutionResult:
        """``submit_step`` + ``collect_step`` back-to-back (window 1)."""
        self.submit_step(step, labels, features=features, ledger=ledger)
        return self.collect_step(
            server_params, liveness=liveness, merge_mask=merge_mask,
            ema_state=ema_state, collect_grads=collect_grads, report=report)

    # -- the shared event pump ------------------------------------------------

    def _pump(self, timeout: Optional[float]) -> bool:
        """Drain ONE transport response into its step's buffers; returns
        False on timeout/idle."""
        got = self.transport.next_response(timeout)
        if got is None:
            return False
        k, resp = got
        op = resp["op"]
        if op == "cut":
            self._on_cut(k, resp)
        elif op == "step_done":
            st = self._inflight.get(resp["step"])
            if st is not None:
                st.done[k] = True
                st.grads[k] = resp.get("grad")
        # "grad" responses are per-microbatch acks; nothing to do
        return True

    def _on_cut(self, k: int, resp: dict) -> None:
        now = time.monotonic()
        step, m = resp["step"], resp["mb"]
        st = self._inflight.get(step)
        if st is None:
            # the step was already collected (a no-wait straggler finishing
            # long after the fact): the payload is dropped, but the arrival
            # still feeds the EWMA so a recovered client can re-open the
            # deadline window
            first = self._retired_first_t.get((step, m))
            if self.deadline is not None and first is not None:
                self.deadline.observe(k, now - first)
            return
        if m not in st.first_t:
            st.first_t[m] = now
        if self.deadline is not None:
            spread = now - st.first_t[m]
            if self.mode == "nowait" and m not in st.merged:
                # this cut will make the merge — but role 0 may have drained
                # it long after delivery (busy on an earlier microbatch or
                # the expired-window sweep), so the raw drain spread can
                # include server time.  Clamp to the deadline window: a cut
                # that made the merge arrived within it by definition.
                window = self.static_deadline_s
                if window is None:
                    window = self.deadline.deadline_s()
                if window is not None:
                    spread = min(spread, window)
            # genuinely late arrivals (mb already merged) observe their raw
            # spread — that is how a recovered straggler earns its way back
            self.deadline.observe(k, spread)
        cut = resp["cut"].detach()  # the wire carries values, no history
        if self.agg_tree is not None:
            # a top-level client's combined subtree frame: every edge under
            # it carried one frame of the same shape (tree_cut[l] tags)
            for member in self.agg_tree.subtree(k):
                st.ledger.record_spec(self._schedule.cuts[member], cut)
        elif self.compress is not None:
            # the payload is the worker's lossy encode: record the codec's
            # wire bytes, not the dense carrier that crosses the transport
            st.ledger.record_spec_bytes(
                self._schedule.cuts[k],
                comp_lib.payload_bytes(cut, self.compress,
                                       self.topk_fraction))
        else:
            st.ledger.record_spec(self._schedule.cuts[k], cut)
        if m in st.merged:
            return  # missed the merge: payload discarded at role 0
        st.cuts.setdefault(m, {})[k] = cut

    def _retire(self, st: _InflightStep) -> None:
        del self._inflight[st.step]
        for m, t in st.first_t.items():
            self._retired_first_t[(st.step, m)] = t
        while len(self._retired_first_t) > _RETIRED_FIRST_T_KEEP:
            self._retired_first_t.pop(next(iter(self._retired_first_t)))

    # -- gathering ------------------------------------------------------------

    def _gather(self, st: _InflightStep, m: int, liveness):
        """Collect microbatch ``m``'s cuts; returns (live_row, deadline_s)."""
        K = self.transport.num_clients

        def have() -> int:
            return len(st.cuts.get(m, {}))

        def barrier(need: int = K, what: str = "cuts") -> None:
            while have() < need:
                if not self._pump(None):
                    raise self._idle_error(
                        f"awaiting {what}", f"step {st.step} mb {m}: "
                        f"{have()}/{need} in")

        if self.agg_tree is not None:
            # barrier on the min(F, K) top-level combined frames: the
            # O(K) -> O(F) role-0 win
            barrier(len(self.agg_tree.top_level), "tree frames")
            return [1.0] * K, None
        if liveness is not None:
            # simulated clock: the transport delivers every cut; the given
            # matrix decides who made the merge
            barrier()
            return [float(x) for x in liveness[m]], None
        if self.mode != "nowait":
            barrier()
            return [1.0] * K, None

        # real no-wait: grace window after the first arrival
        deadline_used = None
        while have() < K:
            if m not in st.first_t:
                self._pump(None)  # the first cut opens the window
                continue
            d = self.static_deadline_s
            if d is None:
                d = self.deadline.deadline_s()
            if d is None:
                # bootstrap barrier: no estimate yet, wait for everyone
                if not self._pump(None):
                    raise self._idle_error(
                        "awaiting cuts at the bootstrap barrier",
                        f"step {st.step} mb {m}: {have()}/{K} in")
                continue
            deadline_used = d
            remaining = (st.first_t[m] + d) - time.monotonic()
            if remaining <= 0:
                # window expired — but sweep the queue first: a cut that was
                # DELIVERED while role 0 was busy on an earlier microbatch
                # beat the deadline and must not be counted as a miss (the
                # drain timestamp, not the true arrival, is all we see)
                while have() < K and self._pump(0.0):
                    pass
                if have() < K:
                    break
                continue
            self._pump(remaining)
        if (self.deadline is not None and self.deadline.initial_s is None
                and have() == K):
            # seed the adaptive controller from the first full barrier
            self.deadline.seed_from_observations()
        arrived = st.cuts.get(m, {})
        return [1.0 if k in arrived else 0.0 for k in range(K)], deadline_used

    def _build_report(self, elapsed_s, live_matrix, misses, ledger, cuts,
                      deadline_s, staleness) -> ExecReport:
        """``cuts`` is the last microbatch's cut set: a (K, ...) stack for
        the uniform merges, a per-client list for a ``merge_fn``."""
        K = self.transport.num_clients
        if self.merge_fn is not None:
            # cuts differ in shape per client: the per-client figures are
            # means, and the collective is the all-gather the program merge
            # implies (the server needs every client's segment)
            per_mb_elements = int(round(sum(c.numel() for c in cuts) / K))
            strategy = "concat"
            cut_bytes = int(round(sum(
                ledger.bytes_with_tag(f"cut[{k}]") for k in range(K)) / K))
            itemsize = cuts[0].element_size()
        else:
            per_mb_elements = cuts[0].numel()
            strategy = self.merge
            # the uplink tag is masked_cut[0] under secure aggregation
            cut_bytes = ledger.bytes_with_tag(self._schedule.cuts[0].tag)
            if self.agg_tree is not None:
                # tree_cut[0] is shared by every top-level edge: divide out
                # for the same per-client figure the star reports
                cut_bytes //= len(self.agg_tree.top_level)
            itemsize = cuts.element_size()
        return ExecReport(
            mode=self.mode,
            transport=type(self.transport).__name__,
            step_time_s=elapsed_s,
            microbatches=self.microbatches,
            live=live_matrix,
            misses_per_client=misses,
            cut_bytes_per_client=cut_bytes,
            collective_bytes_per_client=self.microbatches
            * collective_bytes_per_merge(strategy, per_mb_elements, K,
                                         itemsize),
            deadline_s=deadline_s,
            staleness=staleness,
        )
