"""The serving message schedule and the communications ledger.

Roles (Ceballos et al. 2020, as the paper uses them): role 1 holds
features only, role 3 holds features AND labels, role 0 is the
compute-only server.  Every message is recorded in a :class:`Ledger`
whose byte counts must match the analytic models in
:mod:`repro_torch.core.costs` (asserted in tests).

This slice carries the serving half of the JAX package's schedule: the
four serving wire kinds and :func:`serve_schedule`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core import compat


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
    phase: str      # "serve"
    cost_model: str  # function name in repro_torch.core.costs


#: the wire kinds this slice schedules (the serving half of the registry)
WIRE_KINDS: dict[str, WireKind] = {spec.kind: spec for spec in (
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
