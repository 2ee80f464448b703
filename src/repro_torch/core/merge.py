"""The paper's five cut-layer merge strategies, with client-drop semantics.

``merge_stacked`` is the functional form over stacked client outputs
``(K, ..., D)``: the plain PyTorch version of the fused ``merge_pool``
kernel, and what the CPU path runs.

Drop semantics (paper §4.3): a dropped client contributes its strategy's
neutral element; ``avg`` renormalizes by the number of live clients so the
merged scale is drop-invariant.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MERGE_STRATEGIES

NEG_INF = -3.0e38  # ~ -max_float32; neutral element for max


def neutral_element(strategy: str) -> float:
    return {"sum": 0.0, "avg": 0.0, "concat": 0.0, "max": NEG_INF,
            "mul": 1.0}[strategy]


def merge_stacked(
    outputs: torch.Tensor,  # (K, ..., D) stacked client cut activations
    strategy: str,
    *,
    live_mask: Optional[torch.Tensor] = None,  # (K,) bool/float, 1 = alive
) -> torch.Tensor:
    """Merge K client outputs. Result (..., D) — or (..., K*D) for concat."""
    if strategy not in MERGE_STRATEGIES:
        raise ValueError(f"unknown merge {strategy!r}")
    K = outputs.shape[0]
    if live_mask is None:
        live = torch.ones((K,), dtype=outputs.dtype, device=outputs.device)
    else:
        live = live_mask.to(device=outputs.device, dtype=outputs.dtype)
    lv = live.reshape((K,) + (1,) * (outputs.ndim - 1))

    if strategy == "sum":
        return torch.sum(outputs * lv, dim=0)
    if strategy == "avg":
        n_live = torch.clamp(torch.sum(live), min=1.0)
        return torch.sum(outputs * lv, dim=0) / n_live
    if strategy in ("max", "mul"):
        neutral = torch.full_like(outputs, neutral_element(strategy))
        masked = torch.where(lv > 0, outputs, neutral)
        if strategy == "mul":
            return torch.prod(masked, dim=0)
        out = torch.amax(masked, dim=0)
        # all clients dropped -> zeros, not -inf
        return torch.where(torch.sum(live) > 0, out, torch.zeros_like(out))
    # concat: dropped clients contribute zeros (the server still sees K*D)
    moved = torch.movedim(outputs * lv, 0, -2)  # (..., K, D)
    return moved.reshape(*moved.shape[:-2], K * outputs.shape[-1])
