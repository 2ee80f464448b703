"""The protocol's message schedules, the communications ledger and the
serial reference step.

Roles (Ceballos et al. 2020, as the paper uses them): role 1 holds
features only, role 3 holds features AND labels, role 0 is the
compute-only server.  Every message is recorded in a :class:`Ledger`
whose byte counts must match the analytic models in
:mod:`repro_torch.core.costs` (asserted in tests).  The arithmetic of a
training step is exactly end-to-end backprop through the merged graph
(paper §3): the protocol is a schedule, not a different algorithm.

The port carries the JAX package's whole wire-kind registry: the plain
star (``cut``/``jac``/``head_out``/``head_jac``/``aux``), the three
overlays' variants (``masked_cut`` under secure aggregation,
``compressed_cut``/``compressed_jac`` under a codec,
``tree_cut``/``tree_jac`` along an aggregation tree), the one-time key
exchange (``keyx_pub``/``keyx_bcast``) and the four serving kinds.
Unsound overlay compositions reject through the compat matrix.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.core import compat
from repro_torch.core import merge as merge_lib
from repro_torch.tree_util import tree_leaves, tree_unflatten


@dataclass
class Message:
    sender: str
    receiver: str
    tag: str
    num_bytes: int


@dataclass
class Ledger:
    messages: list[Message] = field(default_factory=list)

    def record(self, sender: str, receiver: str, tag: str, tensor) -> None:
        self.record_bytes(sender, receiver, tag,
                          tensor.numel() * tensor.element_size())

    def record_bytes(self, sender: str, receiver: str, tag: str,
                     num_bytes: int) -> None:
        """Record a payload of known wire size (e.g. int32 token ids)."""
        self.messages.append(Message(sender, receiver, tag, num_bytes))

    def record_spec(self, spec: "MessageSpec", tensor) -> None:
        self.record(spec.sender, spec.receiver, spec.tag, tensor)

    def record_spec_bytes(self, spec: "MessageSpec", num_bytes: int) -> None:
        self.record_bytes(spec.sender, spec.receiver, spec.tag, num_bytes)

    def sent_by(self, who: str) -> int:
        return sum(m.num_bytes for m in self.messages if m.sender == who)

    def received_by(self, who: str) -> int:
        return sum(m.num_bytes for m in self.messages if m.receiver == who)

    def bytes_with_tag(self, tag: str) -> int:
        return sum(m.num_bytes for m in self.messages if m.tag == tag)

    def total(self) -> int:
        return sum(m.num_bytes for m in self.messages)


def _role_of(client: int, label_holder: int) -> str:
    return "role3" if client == label_holder else "role1"


@dataclass(frozen=True)
class WireKind:
    """One registered message kind: its direction, the protocol phase it
    belongs to, and the :mod:`repro_torch.core.costs` function that prices
    its bytes."""

    kind: str
    direction: str  # "up" (toward role 0) | "down" (from role 0)
    phase: str      # "train" | "keyx" | "serve"
    cost_model: str  # function name in repro_torch.core.costs


#: the wire-kind registry (the JAX package's, kind for kind): every
#: ``MessageSpec.kind`` must be one of these, each priced by a function of
#: :mod:`repro_torch.core.costs`
WIRE_KINDS: dict[str, WireKind] = {spec.kind: spec for spec in (
    WireKind(kind="cut", direction="up", phase="train",
             cost_model="cut_bytes"),
    WireKind(kind="masked_cut", direction="up", phase="train",
             cost_model="masked_cut_bytes"),
    WireKind(kind="compressed_cut", direction="up", phase="train",
             cost_model="wire_bytes"),
    WireKind(kind="tree_cut", direction="up", phase="train",
             cost_model="tree_cut_bytes"),
    WireKind(kind="head_out", direction="down", phase="train",
             cost_model="head_exchange_bytes"),
    WireKind(kind="aux", direction="down", phase="train",
             cost_model="aux_exchange_bytes"),
    WireKind(kind="head_jac", direction="up", phase="train",
             cost_model="head_exchange_bytes"),
    WireKind(kind="jac", direction="down", phase="train",
             cost_model="cut_bytes"),
    WireKind(kind="compressed_jac", direction="down", phase="train",
             cost_model="wire_bytes"),
    WireKind(kind="tree_jac", direction="down", phase="train",
             cost_model="tree_cut_bytes"),
    WireKind(kind="keyx_pub", direction="up", phase="keyx",
             cost_model="key_exchange_bytes"),
    WireKind(kind="keyx_bcast", direction="down", phase="keyx",
             cost_model="key_exchange_bytes"),
    WireKind(kind="serve_prompt", direction="down", phase="serve",
             cost_model="serve_prefill_bytes"),
    WireKind(kind="serve_prefill_cut", direction="up", phase="serve",
             cost_model="serve_prefill_bytes"),
    WireKind(kind="serve_token", direction="down", phase="serve",
             cost_model="serve_decode_bytes"),
    WireKind(kind="serve_cut", direction="up", phase="serve",
             cost_model="serve_decode_bytes"),
)}


@dataclass(frozen=True)
class MessageSpec:
    """One protocol message, independent of any payload.  ``kind`` must be
    registered in :data:`WIRE_KINDS`."""

    sender: str
    receiver: str
    tag: str
    kind: str
    client: Optional[int] = None

    def __post_init__(self):
        if self.kind not in WIRE_KINDS:
            raise ValueError(
                f"unregistered wire kind {self.kind!r} (tag {self.tag!r}) "
                f"— register it in protocol.WIRE_KINDS with a direction, "
                f"phase, and costs.* byte model")


@dataclass(frozen=True)
class StepSchedule:
    """The training message schedule, per step (or microbatch): the
    one-time pairwise key exchange (``keyx_pub[k]`` up, ``keyx_bcast[k]``
    down; recorded only under secure aggregation), K cut uplinks, the
    role-0 <-> role-3 head exchange (``head_output`` down,
    ``head_jacobian`` up) with its auxiliary-loss slot (``aux_loss``,
    recorded only for families whose server computes a loss term of its
    own), and K jacobian downlinks.

    The cut uplinks are tagged ``cut[k]``, ``masked_cut[k]`` under secure
    aggregation (role 0 observes mask-blinded activations; only their sum
    is meaningful) or ``compressed_cut[k]`` under a codec, and the
    jacobian downlinks ``jac[k]`` or ``compressed_jac[k]``: a compressed
    message's bytes are the codec's wire frame (``costs.wire_bytes``).
    Under a ``tree`` (an ``AggTree``) client k's cut goes to its relay
    parent (role 0 for the top level) as ``tree_cut[level]`` and its
    jacobian comes back down the same edge as ``tree_jac[level]``, so
    role 0 receives only the ``min(F, K)`` top-level frames
    (``costs.tree_cut_bytes`` prices each level).  A tree composes with
    secure aggregation; compression composes with neither."""

    cuts: tuple[MessageSpec, ...]
    head_out: MessageSpec
    aux: MessageSpec
    head_jac: MessageSpec
    jacs: tuple[MessageSpec, ...]
    key_pubs: tuple[MessageSpec, ...] = ()
    key_bcasts: tuple[MessageSpec, ...] = ()
    secure: bool = False
    compress: Optional[str] = None
    # duck-typed AggTree (parent/edge_level/top_level/subtree), so core
    # does not import runtime.topology
    tree: Optional[object] = None


def step_schedule(num_clients: int, label_holder: int = 0, *,
                  secure: bool = False, compress: Optional[str] = None,
                  tree=None) -> StepSchedule:
    """The training schedule for ``num_clients`` feature holders.  Unsound
    overlay compositions reject through the compat matrix."""
    compat.check("schedule", secure=secure, compress=compress, tree=tree)
    cut_kind = ("masked_cut" if secure
                else "compressed_cut" if compress is not None else "cut")
    jac_kind = "compressed_jac" if compress is not None else "jac"
    if tree is not None:
        if getattr(tree, "num_clients", None) != num_clients:
            raise ValueError(
                f"tree covers {getattr(tree, 'num_clients', None)} clients, "
                f"schedule has {num_clients}")

        def hop(k):
            # client k's relay parent (role 0 at the top level), and the
            # tree level of the edge between them
            p = tree.parent(k)
            return ("role0" if p is None else _role_of(p, label_holder),
                    tree.edge_level(k))

        cuts = tuple(MessageSpec(_role_of(k, label_holder), hop(k)[0],
                                 f"tree_cut[{hop(k)[1]}]", "tree_cut", k)
                     for k in range(num_clients))
        jacs = tuple(MessageSpec(hop(k)[0], _role_of(k, label_holder),
                                 f"tree_jac[{hop(k)[1]}]", "tree_jac", k)
                     for k in range(num_clients))
    else:
        cuts = tuple(MessageSpec(_role_of(k, label_holder), "role0",
                                 f"{cut_kind}[{k}]", cut_kind, k)
                     for k in range(num_clients))
        jacs = tuple(MessageSpec("role0", _role_of(k, label_holder),
                                 f"{jac_kind}[{k}]", jac_kind, k)
                     for k in range(num_clients))
    return StepSchedule(
        cuts=cuts,
        head_out=MessageSpec("role0", "role3", "head_output", "head_out"),
        aux=MessageSpec("role0", "role3", "aux_loss", "aux"),
        head_jac=MessageSpec("role3", "role0", "head_jacobian", "head_jac"),
        jacs=jacs,
        key_pubs=tuple(MessageSpec(_role_of(k, label_holder), "role0",
                                   f"keyx_pub[{k}]", "keyx_pub", k)
                       for k in range(num_clients)),
        key_bcasts=tuple(MessageSpec("role0", _role_of(k, label_holder),
                                     f"keyx_bcast[{k}]", "keyx_bcast", k)
                         for k in range(num_clients)),
        secure=secure,
        compress=compress,
        tree=tree,
    )


@dataclass(frozen=True)
class ServeSchedule:
    """The serving message schedule, four per-client message classes:

    * ``prompts``      — role 0 -> client k: the int32 prompt ids
      (tag ``serve_prompt[k]``);
    * ``prefill_cuts`` — client k -> role 0: the one-time full-prompt cut
      slice (tag ``serve_prefill_cut[k]``);
    * ``tokens``       — role 0 -> client k: the last sampled token id, one
      int32 per decode round (tag ``serve_token[k]``);
    * ``cuts``         — client k -> role 0: the one-token decode cut frame
      (tag ``serve_cut[k]``).

    Serving is forward-only and ships raw cut tensors."""

    prompts: tuple[MessageSpec, ...]
    prefill_cuts: tuple[MessageSpec, ...]
    tokens: tuple[MessageSpec, ...]
    cuts: tuple[MessageSpec, ...]


def serve_schedule(num_clients: int, label_holder: int = 0, *,
                   secure: bool = False,
                   compress: Optional[str] = None,
                   tree=None) -> ServeSchedule:
    """The serving schedule for ``num_clients`` feature holders.  The
    compat matrix rejects the training-path overlays (secure, compressed,
    tree-routed wires) right here."""
    compat.check("schedule", serve=True, secure=secure, compress=compress,
                 tree=tree)

    def specs(kind: str, up: bool) -> tuple[MessageSpec, ...]:
        out = []
        for k in range(num_clients):
            client = _role_of(k, label_holder)
            sender, receiver = (client, "role0") if up else ("role0", client)
            out.append(MessageSpec(sender, receiver, f"{kind}[{k}]", kind, k))
        return tuple(out)

    return ServeSchedule(
        prompts=specs("serve_prompt", up=False),
        prefill_cuts=specs("serve_prefill_cut", up=True),
        tokens=specs("serve_token", up=False),
        cuts=specs("serve_cut", up=True),
    )


def protocol_step(
    tower_fwd,  # (tower_params_k, x_k) -> cut; or a per-client list of K
    server_fwd: Callable,  # (server_params, merged) -> logits
    loss_fn: Callable,  # (logits, labels) -> scalar
    tower_params: list,
    server_params,
    features: list,  # per-client feature tensors
    labels,  # role-3 context, batch-major
    merge: str,
    *,
    label_holder: int = 0,
    live_mask: Optional[torch.Tensor] = None,
    ledger: Optional[Ledger] = None,
    compress: Optional[str] = None,
    topk_fraction: float = 0.25,
    **executor_kwargs,
):
    """One paper-protocol training step; returns (loss, tower_grads,
    server_grads, ledger).

    Feature holders send cut activations to role 0; role 0 sends the head
    output to role 3; role 3 returns the head jacobian; role 0 returns the
    per-client cut jacobians.  With ``compress`` the workers compress
    their cuts and the executor its jacobians, from the zero residual.
    A thin wrapper: the numerics live in the
    :class:`~repro_torch.runtime.executor.Executor` (serial mode, one
    microbatch, the ``"neutral"`` drop policy, which merges with the plain
    version) over the inline :class:`~repro_torch.transport.SimTransport`.
    """
    # function-level imports: runtime/transport import this module for the
    # schedule and Ledger definitions
    from repro_torch.runtime.executor import Executor
    from repro_torch.transport.base import SimTransport, TowerWorker

    K = len(tower_params)
    tower_fwds = (list(tower_fwd) if isinstance(tower_fwd, (list, tuple))
                  else [tower_fwd] * K)
    workers = [TowerWorker(k, tower_fwds[k], tower_params[k],
                           compress=compress, topk_fraction=topk_fraction)
               for k in range(K)]
    executor = Executor(
        SimTransport(workers), server_fwd, loss_fn, merge, mode="serial",
        microbatches=1, label_holder=label_holder, drop_policy="neutral",
        compress=compress, topk_fraction=topk_fraction, **executor_kwargs)
    res = executor.run_step(server_params, labels, features=list(features),
                            merge_mask=live_mask, ledger=ledger,
                            collect_grads=True)
    return res.loss, res.tower_grads, res.server_grads, res.ledger


def assert_equivalent_to_monolithic(
    tower_fwd, server_fwd, loss_fn, tower_params, server_params,
    features, labels, merge: str, atol: float = 1e-5,
):
    """The paper's §3 identity: the protocol == end-to-end backprop.
    ``tower_fwd`` is one callable or a per-client list, as in
    :func:`protocol_step`."""
    loss_p, tg_p, sg_p, _ = protocol_step(
        tower_fwd, server_fwd, loss_fn, tower_params, server_params,
        features, labels, merge)

    K = len(tower_params)
    tower_fwds = (list(tower_fwd) if isinstance(tower_fwd, (list, tuple))
                  else [tower_fwd] * K)
    tree = (list(tower_params), server_params)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    towers, server = tree_unflatten(tree, leaves)
    with torch.enable_grad():
        stacked = torch.stack([tower_fwds[k](towers[k], features[k])
                               for k in range(K)])
        merged = merge_lib.merge_stacked(stacked, merge)
        loss_m = loss_fn(server_fwd(server, merged), labels)
    grads_m = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(loss_m, leaves, allow_unused=True))]

    torch.testing.assert_close(loss_p, loss_m.detach(), atol=atol, rtol=1e-5)
    for a, b in zip(tree_leaves((tg_p, sg_p)), grads_m):
        torch.testing.assert_close(a, b, atol=atol, rtol=1e-4)
