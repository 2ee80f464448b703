"""Cut-layer leakage measurement and reduction (beyond the paper).

The paper's §4.4 points at minimizing distance correlation (NoPeek,
Vepakomma et al. 2019) as future work: the server observes cut
activations, and the distance correlation dCor(X, Z) between a client's
raw features X and its transmitted activation Z quantifies how much raw
structure leaks.

* :func:`distance_correlation` — the (biased, V-statistic) sample dCor;
* :func:`leakage_penalty` — a NoPeek-style additive loss term;
* :func:`measure_split_leakage` — per-client dCor of a split MLP;
* :func:`make_nopeek_train_step` — split training with the penalty.

No entry point reaches this module: it is the audit run on what role 0
observes (masked cuts under secure aggregation leak less).
"""
from __future__ import annotations

import torch

from repro_torch.configs.vertical_mlp import MLPSplitConfig
from repro_torch.core import merge as merge_lib
from repro_torch.core import split_model, towers


def _pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix, x: (n, d) -> (n, n)."""
    sq = torch.sum(torch.square(x), dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    return torch.sqrt(torch.clamp(d2, min=1e-12))


def _double_center(d: torch.Tensor) -> torch.Tensor:
    row = torch.mean(d, dim=0, keepdim=True)
    col = torch.mean(d, dim=1, keepdim=True)
    return d - row - col + torch.mean(d)


def distance_correlation(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Sample distance correlation in [0, 1]; x: (n, dx), z: (n, dz)."""
    a = _double_center(_pairwise_dist(x.float()))
    b = _double_center(_pairwise_dist(z.float()))
    dcov2 = torch.mean(a * b)
    dvar_x = torch.mean(a * a)
    dvar_z = torch.mean(b * b)
    denom = torch.sqrt(torch.clamp(dvar_x * dvar_z, min=1e-12))
    return torch.sqrt(torch.clamp(dcov2, min=0.0) / denom)


def leakage_penalty(features: list, cuts: torch.Tensor) -> torch.Tensor:
    """Mean dCor between each client's raw slice and its cut activation."""
    return torch.mean(torch.stack([
        distance_correlation(features[k], cuts[k])
        for k in range(cuts.shape[0])]))


def measure_split_leakage(params: dict, cfg: MLPSplitConfig,
                          x: torch.Tensor) -> list[float]:
    """Per-client dCor(raw slice, cut activation) of a split model."""
    out = []
    with torch.no_grad():
        for k, s in enumerate(split_model.feature_slices(cfg)):
            xk = split_model.client_columns(x, s)
            cut = towers.mlp_tower_apply(params["towers"][k], xk)
            out.append(float(distance_correlation(xk, cut)))
    return out


def make_nopeek_train_step(cfg: MLPSplitConfig, optimizer, *,
                           leakage_weight: float = 0.1):
    """Split training step with the NoPeek distance-correlation penalty:
    ``step(params, opt_state, x, y) -> (params, opt_state, loss, task,
    leak)``, eager, with the port's out-of-place optimizers."""
    slices = split_model.feature_slices(cfg)
    parts = {}

    def loss_fn(params, x, y):
        feats = [split_model.client_columns(x, s) for s in slices]
        cuts = torch.stack([
            towers.mlp_tower_apply(params["towers"][k], feats[k])
            for k in range(cfg.num_clients)])
        merged = merge_lib.merge_stacked(cuts, cfg.merge)
        logits = towers.mlp_tower_apply(params["server"], merged)
        task = split_model.softmax_xent(logits, y, cfg.num_classes)
        leak = leakage_penalty(feats, cuts)
        parts["task"], parts["leak"] = task.detach(), leak.detach()
        return task + leakage_weight * leak

    def step(params, opt_state, x, y):
        loss, grads = split_model._value_and_grad(loss_fn, params, x, y)
        params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, loss, parts["task"], parts["leak"]

    return step
