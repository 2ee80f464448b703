"""The feature-interaction compatibility matrix — the port's own copy.

Carries the rules of the JAX package's matrix that the port enforces:
those whose enforcement layers include ``config`` (``VerticalConfig``
validation), ``schedule`` (``step_schedule`` /
``serve_schedule`` construction), ``engine`` (the simulators' step
plans), ``executor`` (``Executor`` construction), ``worker``
(``TowerWorker``, the privacy principal's own guard), ``train``
(``train_split``, before workers are built), ``launch`` (the CLI
launcher, which phrases the rejection by flag through :func:`cli_reject`)
or ``serve`` (``SplitLMServer``), each listed at the port's layers
only.
Each layer rejects through :func:`check`; a rule's key, features and
``reason`` are the JAX package's, so both packages reject a composition
with the same words (``tests/test_torch_train.py`` holds the two tables
together).
"""
from __future__ import annotations

from dataclasses import dataclass

#: enforcement-layer name -> the port module whose source calls check()
LAYER_MODULES = {
    "config": "src/repro_torch/configs/base.py",
    "schedule": "src/repro_torch/core/protocol.py",
    "engine": "src/repro_torch/runtime/engine.py",
    "executor": "src/repro_torch/runtime/executor.py",
    "worker": "src/repro_torch/transport/base.py",
    "train": "src/repro_torch/train/loop.py",
    "launch": "src/repro_torch/launch/train.py",
    "serve": "src/repro_torch/serve/split_serve.py",
}

#: feature name -> how the CLI launcher names it in a SystemExit
CLI_NAMES = {
    "secure": "--secure-agg",
    "compress": "--compress",
    "tree": "--agg-tree-fanout",
    "nowait": "--runtime nowait",
    "merge_fn": "a program merge_fn",
    "nonadditive": "a non-additive merge",
    "impute": "--runtime nowait (EMA imputation)",
    "serve": "serving",
}

#: merges with a partial-sum regrouping / mask-cancelling sum
ADDITIVE_MERGES = ("sum", "avg")


@dataclass(frozen=True)
class CompatRule:
    """One unsound feature composition, rejected at each of ``layers``."""

    key: str
    features: tuple[str, ...]
    layers: tuple[str, ...]
    reason: str


RULES: tuple[CompatRule, ...] = (
    # order matters: check() raises the FIRST active rule (the JAX
    # package's order)
    CompatRule(
        key="merge-fn-impute",
        features=("merge_fn", "impute"),
        layers=("executor",),
        reason=(
            "a program merge_fn (non-uniform cuts) cannot EMA-impute "
            "missing clients — there is no per-client frame to impute "
            "into the concatenation; use a barrier mode "
            "(serial/pipelined)"),
    ),
    CompatRule(
        key="secure-nonadditive",
        features=("secure", "nonadditive"),
        layers=("config", "executor"),
        reason=(
            "secure aggregation needs an additively homomorphic merge "
            "(sum/avg) for the pairwise masks to cancel — max/mul/concat "
            "have no mask-cancelling sum"),
    ),
    CompatRule(
        key="secure-merge-fn",
        features=("secure", "merge_fn"),
        layers=("executor", "train"),
        reason=(
            "secure aggregation cannot run a program merge_fn "
            "(non-uniform cuts, e.g. the vlm sequence concat): role 0 "
            "must SUM the masked cuts for the pairwise masks to cancel, "
            "and a concatenation exposes each masked segment with nothing "
            "to cancel against"),
    ),
    CompatRule(
        key="secure-nowait",
        features=("secure", "nowait"),
        layers=("executor", "train", "launch"),
        reason=(
            "secure aggregation requires barrier execution "
            "(drop_policy='fused'): a client dropped in no-wait mode (or "
            "recovered by any non-fused drop policy) leaves its pairwise "
            "masks uncancelled and the aggregate unusable — there is no "
            "dropout-recovery round"),
    ),
    CompatRule(
        key="secure-compress",
        features=("compress", "secure"),
        layers=("schedule", "engine", "executor", "worker", "train",
                "launch"),
        reason=(
            "secure aggregation and cut compression cannot compose: "
            "additive masks do not cancel through quantized/sparsified "
            "values, so the merged sum would be garbage while the uplinks "
            "silently stop being blinded aggregates — run one or the "
            "other"),
    ),
    CompatRule(
        key="compress-merge-fn",
        features=("compress", "merge_fn"),
        layers=("executor",),
        reason=(
            "cut compression cannot run under a program merge_fn "
            "(non-uniform cuts, e.g. the vlm sequence concat): the wire "
            "contract audits one k-per-vector frame per uplink, which a "
            "non-uniform concatenation does not have"),
    ),
    CompatRule(
        key="tree-nonadditive",
        features=("tree", "nonadditive"),
        layers=("engine", "executor", "train", "launch"),
        reason=(
            "tree aggregation needs an additively homomorphic merge: "
            "relays forward SUBTREE PARTIAL SUMS, which only a plain "
            "additive merge (sum/avg) regroups — max/mul/concat have no "
            "partial-sum regrouping"),
    ),
    CompatRule(
        key="tree-merge-fn",
        features=("tree", "merge_fn"),
        layers=("executor", "train"),
        reason=(
            "tree aggregation cannot run a program merge_fn (non-uniform "
            "cuts, e.g. the vlm sequence concat): relays partial-sum "
            "uniform cut tensors under an additive merge (sum/avg), and a "
            "concatenation has no subtree partial sum"),
    ),
    CompatRule(
        key="tree-compress",
        features=("tree", "compress"),
        layers=("schedule", "engine", "executor", "worker", "train",
                "launch"),
        reason=(
            "tree aggregation and cut compression cannot compose: relays "
            "partial-sum cut tensors, and codec frames (topk bitmaps / "
            "int8 codes) cannot be partial-summed without breaking each "
            "stream's error-feedback state — run one or the other"),
    ),
    CompatRule(
        key="tree-nowait",
        features=("tree", "nowait"),
        layers=("engine", "executor", "train", "launch"),
        reason=(
            "tree aggregation requires barrier execution "
            "(drop_policy='fused'): a client folded into a relay's "
            "combined frame has no per-client arrival to deadline, drop, "
            "or EMA-impute at a no-wait merge"),
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


def active_features(*, secure=False, compress=None, tree=None, nowait=False,
                    merge_fn=None, merge=None, impute=False,
                    serve=False) -> dict[str, bool]:
    """Normalize caller flags (a codec name, a tree object, a merge name, a
    callable) into booleans."""
    return {
        "secure": bool(secure),
        "compress": compress is not None and compress is not False,
        "tree": tree is not None and tree is not False,
        "nowait": bool(nowait),
        "merge_fn": merge_fn is not None and merge_fn is not False,
        "nonadditive": merge is not None and merge not in ADDITIVE_MERGES,
        "impute": bool(impute),
        "serve": bool(serve),
    }


def check(layer: str, *, secure=False, compress=None, tree=None,
          nowait=False, merge_fn=None, merge=None, impute=False,
          serve=False, context: str = "") -> None:
    """Reject the first rule whose features are all active and which
    declares ``layer`` as an enforcement point."""
    if layer not in LAYER_MODULES:
        raise ValueError(f"unknown compat layer {layer!r} "
                         f"(declared: {tuple(LAYER_MODULES)})")
    active = active_features(
        secure=secure, compress=compress, tree=tree, nowait=nowait,
        merge_fn=merge_fn, merge=merge, impute=impute, serve=serve)
    for rule in RULES:
        if layer in rule.layers and all(active[f] for f in rule.features):
            raise CompatError(rule, layer, context)


def cli_reject(e: CompatError) -> SystemExit:
    """The launcher's phrasing of a matrix rejection: name the flags, then
    the matrix reason — '--compress cannot run with --secure-agg: ...'."""
    a, b = (CLI_NAMES[f] for f in e.rule.features[:2])
    return SystemExit(f"{a} cannot run with {b}: {e.rule.reason}")
