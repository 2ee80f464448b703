"""The feature-interaction compatibility matrix — the port's own copy.

Carries the rules of the JAX package's matrix that the port's serving
path enforces: those whose enforcement layers include ``schedule``
(``serve_schedule`` construction), ``worker`` (``TowerWorker``, the privacy
principal's own guard) or ``serve`` (``SplitLMServer``).  Each layer
rejects through :func:`check`; a rule's ``reason`` is the JAX package's
text, so both packages reject a composition with the same words.
"""
from __future__ import annotations

from dataclasses import dataclass

#: enforcement-layer name -> the port module whose source calls check()
LAYER_MODULES = {
    "schedule": "src/repro_torch/core/protocol.py",
    "worker": "src/repro_torch/transport/base.py",
    "serve": "src/repro_torch/serve/split_serve.py",
}


@dataclass(frozen=True)
class CompatRule:
    """One unsound feature composition, rejected at each of ``layers``."""

    key: str
    features: tuple[str, ...]
    layers: tuple[str, ...]
    reason: str


RULES: tuple[CompatRule, ...] = (
    CompatRule(
        key="secure-compress",
        features=("compress", "secure"),
        layers=("schedule", "worker"),
        reason=(
            "secure aggregation and cut compression cannot compose: "
            "additive masks do not cancel through quantized/sparsified "
            "values, so the merged sum would be garbage while the uplinks "
            "silently stop being blinded aggregates — run one or the "
            "other"),
    ),
    CompatRule(
        key="tree-compress",
        features=("tree", "compress"),
        layers=("schedule", "worker"),
        reason=(
            "tree aggregation and cut compression cannot compose: relays "
            "partial-sum cut tensors, and codec frames (topk bitmaps / "
            "int8 codes) cannot be partial-summed without breaking each "
            "stream's error-feedback state — run one or the other"),
    ),
    CompatRule(
        key="serve-secure",
        features=("serve", "secure"),
        layers=("schedule", "serve", "worker"),
        reason=(
            "split serving ships raw cut frames: secure aggregation's "
            "masked uplinks are a training-path feature and do not "
            "compose with the serving schedule"),
    ),
    CompatRule(
        key="serve-compress",
        features=("serve", "compress"),
        layers=("schedule", "serve", "worker"),
        reason=(
            "split serving ships raw cut frames: cut compression is a "
            "training-path feature and does not compose with the serving "
            "schedule"),
    ),
    CompatRule(
        key="serve-tree",
        features=("serve", "tree"),
        layers=("schedule",),
        reason=(
            "split serving ships raw cut frames: the aggregation tree is "
            "a training-path overlay with no serving schedule"),
    ),
)


class CompatError(ValueError):
    """An unsound feature composition, rejected at ``layer`` by ``rule``."""

    def __init__(self, rule: CompatRule, layer: str, context: str = ""):
        self.rule = rule
        self.layer = layer
        self.context = context
        prefix = f"{context}: " if context else ""
        super().__init__(f"{prefix}{rule.reason}")


def active_features(*, secure=False, compress=None, tree=None,
                    serve=False) -> dict[str, bool]:
    """Normalize caller flags (a codec name, a tree object) into booleans."""
    return {
        "secure": bool(secure),
        "compress": compress is not None and compress is not False,
        "tree": tree is not None and tree is not False,
        "serve": bool(serve),
    }


def check(layer: str, *, secure=False, compress=None, tree=None,
          serve=False, context: str = "") -> None:
    """Reject the first rule whose features are all active and which
    declares ``layer`` as an enforcement point."""
    if layer not in LAYER_MODULES:
        raise ValueError(f"unknown compat layer {layer!r} "
                         f"(declared: {tuple(LAYER_MODULES)})")
    active = active_features(secure=secure, compress=compress, tree=tree,
                             serve=serve)
    for rule in RULES:
        if layer in rule.layers and all(active[f] for f in rule.features):
            raise CompatError(rule, layer, context)
