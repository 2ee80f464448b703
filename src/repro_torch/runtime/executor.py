"""Executor: drive the training schedule over any transport.

The single execution path behind ``protocol_step`` (serial) and the
split-executing train loop: one role-0 driver that walks
``step_schedule``, records every message in a per-step
:class:`~repro_torch.core.protocol.Ledger`, merges the cut activations,
backprops the server network and returns per-client jacobians — over a
:class:`~repro_torch.transport.Transport`.

The step is split into two halves so a driver can keep several steps in
flight (:class:`~repro_torch.runtime.pipeline.StepPipeline`):

* :meth:`Executor.submit_step` ships every tower-forward request for one
  step and registers its in-flight state (its own Ledger, cut buffers);
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

Not ported yet, and refused loudly: the ``"impute"`` policy and the
``"nowait"`` mode (deadlines, EMA imputation), secure aggregation, cut
compression and aggregation trees (unsound compositions reject through
the compat matrix first, the same words as the JAX package), and the
program shapes the dense family does not use (``server_takes_batch``,
``server_aux``, ``merge_fn``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.core import compat
from repro_torch.core import merge as merge_lib
from repro_torch.core.merge import collective_bytes_per_merge
from repro_torch.core.protocol import Ledger, _reject_unported, step_schedule
from repro_torch.kernels import ops
from repro_torch.tree_util import tree_leaves, tree_map, tree_unflatten

DROP_POLICIES = ("neutral", "fused", "impute")


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
    return tree_map(lambda *leaves: sum(leaves) / len(leaves), *trees)


@dataclass
class ExecReport:
    """Measured (wall-clock) report of one collected step.  Every client
    makes every merge in the ported modes, so the JAX report's liveness
    matrix and miss counts have no counterpart yet."""

    mode: str
    transport: str
    step_time_s: float
    microbatches: int
    cut_bytes_per_client: int
    collective_bytes_per_client: int
    # steps submitted after this one before it was collected: the tower
    # params' delayed-gradient lag (0 = serial semantics, W-1 at window W)
    staleness: int = 0


@dataclass
class ExecutionResult:
    loss: torch.Tensor
    tower_grads: Optional[list]
    server_grads: object
    ledger: Ledger
    report: ExecReport
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
    sent_jacs: list = field(default_factory=list)  # per-client bwd count
    done: list = field(default_factory=list)  # per-client step_done
    grads: list = field(default_factory=list)  # per-client final tower grads


class Executor:
    """Role-0 server driving training steps over a transport.

    One training step is :meth:`submit_step` (ship the tower forwards)
    followed by :meth:`collect_step` (merge, server backward, jacobian
    fan-out, step barrier); :meth:`run_step` runs both back-to-back.

    ``server_fwd(server_params, merged) -> logits`` and ``loss_fn(logits,
    labels) -> scalar`` come from the program.  The server backward is
    ``torch.autograd.grad`` of the loss over the server param leaves and
    the stacked cuts, both fresh leaves made from detached tensors, so it
    never runs back into a tower's graph."""

    def __init__(self, transport, server_fwd: Callable, loss_fn: Callable,
                 merge: str, *, mode: str = "pipelined", microbatches: int = 1,
                 label_holder: int = 0, drop_policy: Optional[str] = None,
                 server_takes_batch: bool = False, server_aux: bool = False,
                 merge_fn: Optional[Callable] = None,
                 secure_agg: bool = False, compress: Optional[str] = None,
                 agg_tree=None):
        if mode not in ("serial", "pipelined", "nowait"):
            raise ValueError(f"mode must be serial|pipelined|nowait, got {mode!r}")
        if drop_policy is None:
            drop_policy = "impute" if mode == "nowait" else "fused"
        if drop_policy not in DROP_POLICIES:
            raise ValueError(f"drop_policy must be one of {DROP_POLICIES}")
        compat.check(
            "executor", secure=secure_agg, compress=compress, tree=agg_tree,
            merge=merge, merge_fn=merge_fn,
            nowait=mode == "nowait" or drop_policy != "fused",
            impute=drop_policy == "impute",
            context=f"Executor(mode={mode!r}, drop_policy={drop_policy!r})")
        _reject_unported(secure=secure_agg, compress=compress, tree=agg_tree,
                         nowait=mode == "nowait" or drop_policy == "impute")
        for name, on in (("server_takes_batch", server_takes_batch),
                         ("server_aux", server_aux),
                         ("merge_fn", merge_fn is not None)):
            if on:
                raise NotImplementedError(
                    f"Executor: {name} programs are not ported to repro_torch "
                    "yet (the dense family uses none)")
        self.transport = transport
        self.server_fwd = server_fwd
        self.loss_fn = loss_fn
        self.merge = merge
        self.mode = mode
        self.microbatches = microbatches
        self.label_holder = label_holder
        self.drop_policy = drop_policy
        self._schedule = step_schedule(transport.num_clients, label_holder)
        self._inflight: dict[int, _InflightStep] = {}  # insertion-ordered

    def _idle_error(self, phase: str, detail: str = "") -> RuntimeError:
        msg = f"transport idle {phase}"
        if detail:
            msg += f" ({detail})"
        if self._inflight:
            msg += f" [steps in flight: {list(self._inflight)}]"
        return RuntimeError(msg)

    # -- step halves ----------------------------------------------------------

    @property
    def inflight_steps(self) -> list[int]:
        """Steps submitted but not yet collected, oldest first."""
        return list(self._inflight)

    def submit_step(self, step: int, labels: torch.Tensor, *,
                    features: Optional[list] = None,
                    ledger: Optional[Ledger] = None) -> None:
        """Ship every tower-forward request of ``step`` and register its
        in-flight state.  ``features`` (per-client tensors, batch-major)
        ride the requests; omit them when workers own a ``feature_fn``.
        Each step audits its bytes in its OWN Ledger."""
        transport, K, M = (self.transport, self.transport.num_clients,
                           self.microbatches)
        if step in self._inflight:
            raise ValueError(f"step {step} already in flight")
        B = labels.shape[0]
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

    def collect_step(self, server_params, *, merge_mask=None,
                     collect_grads: bool = True) -> ExecutionResult:
        """Collect the OLDEST in-flight step: merge its microbatches, run the
        role-0 forward/backward, fan jacobians out, barrier on
        ``step_done``."""
        if not self._inflight:
            raise RuntimeError("no in-flight step to collect "
                               "(call submit_step first)")
        st = next(iter(self._inflight.values()))
        transport, K, M = (self.transport, self.transport.num_clients,
                           self.microbatches)
        schedule = self._schedule
        staleness = sum(1 for s in self._inflight if s > st.step)
        mbsz = st.mbsz
        server_leaves = tree_leaves(server_params)

        losses, server_grad_acc = [], []
        cuts_in = None
        for m in range(M):
            self._gather(st, m)
            arrived = st.cuts.pop(m)
            cuts_in = torch.stack([arrived[k] for k in range(K)])
            labels_m = st.labels[m * mbsz:(m + 1) * mbsz]

            # fresh leaves over the same storage: the graph starts here
            leaves = [t.detach().requires_grad_(True) for t in server_leaves]
            cuts = cuts_in.requires_grad_(True)
            with torch.enable_grad():
                if self.drop_policy == "neutral":
                    merged = merge_lib.merge_stacked(cuts, self.merge,
                                                     live_mask=merge_mask)
                else:
                    merged = fast_merge(cuts, self.merge)
                logits = self.server_fwd(
                    tree_unflatten(server_params, leaves), merged)
                loss_m = self.loss_fn(logits, labels_m)
            grads = torch.autograd.grad(loss_m, leaves + [cuts])
            # the ledger needs the head output's size only: the logits are
            # not kept past this microbatch
            head_bytes = logits.numel() * logits.element_size()
            del logits, merged
            st.ledger.record_spec_bytes(schedule.head_out, head_bytes)
            st.ledger.record_spec_bytes(schedule.head_jac, head_bytes)
            cut_grads = grads[-1]
            for spec in schedule.jacs:
                k = spec.client
                jac_out = cut_grads[k]
                st.ledger.record_spec(spec, jac_out)
                st.sent_jacs[k] += 1
                transport.submit(k, {"op": "backward", "step": st.step,
                                     "mb": m, "jac": jac_out})
            losses.append(loss_m.detach())
            server_grad_acc.append(tree_unflatten(server_params,
                                                  list(grads[:-1])))

        for k in range(K):
            transport.submit(k, {
                "op": "finish_step", "step": st.step, "microbatches": M,
                "collect": collect_grads, "expected_jacs": st.sent_jacs[k]})
        while not all(st.done):
            if not self._pump(None):
                raise self._idle_error(
                    "awaiting step_done",
                    f"step {st.step}: {sum(st.done)}/{K} workers done")
        del self._inflight[st.step]

        loss = sum(losses) / M
        server_grads = tree_mean(server_grad_acc)
        tower_grads = list(st.grads) if collect_grads else None
        report = self._build_report(time.monotonic() - st.submit_t,
                                    st.ledger, cuts_in, staleness)
        return ExecutionResult(loss, tower_grads, server_grads, st.ledger,
                               report, step=st.step)

    def run_step(self, server_params, labels, *, step: int = 0,
                 features: Optional[list] = None, merge_mask=None,
                 ledger: Optional[Ledger] = None,
                 collect_grads: bool = True) -> ExecutionResult:
        """``submit_step`` + ``collect_step`` back-to-back (window 1)."""
        self.submit_step(step, labels, features=features, ledger=ledger)
        return self.collect_step(server_params, merge_mask=merge_mask,
                                 collect_grads=collect_grads)

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
        st = self._inflight.get(resp["step"])
        if st is None:
            raise RuntimeError(f"client {k}: cut for step {resp['step']}, "
                               "which is not in flight")
        cut = resp["cut"].detach()  # the wire carries values, no history
        st.ledger.record_spec(self._schedule.cuts[k], cut)
        st.cuts.setdefault(resp["mb"], {})[k] = cut

    def _gather(self, st: _InflightStep, m: int) -> None:
        """Barrier on all K cuts of microbatch ``m``."""
        K = self.transport.num_clients
        while len(st.cuts.get(m, {})) < K:
            if not self._pump(None):
                raise self._idle_error(
                    "awaiting cuts",
                    f"step {st.step} mb {m}: {len(st.cuts.get(m, {}))}/{K} "
                    "in")

    def _build_report(self, elapsed_s, ledger, cuts,
                      staleness) -> ExecReport:
        """``cuts`` is the last microbatch's (K, ...) cut stack."""
        K = self.transport.num_clients
        return ExecReport(
            mode=self.mode,
            transport=type(self.transport).__name__,
            step_time_s=elapsed_s,
            microbatches=self.microbatches,
            cut_bytes_per_client=ledger.bytes_with_tag(
                self._schedule.cuts[0].tag),
            collective_bytes_per_client=self.microbatches
            * collective_bytes_per_merge(self.merge, cuts[0].numel(), K,
                                         cuts.element_size()),
            staleness=staleness,
        )
