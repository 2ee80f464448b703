"""Plain PyTorch versions of the port's kernels.

These are the source of truth on the CPU and the yardstick of correctness
on the card: each kernel must match its plain version here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import merge as merge_lib


def merge_pool(stacked: torch.Tensor, strategy: str,
               live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """stacked: (K, B, D) -> (B, D) for the reductions, (B, K*D) for the
    gather-concat."""
    if strategy not in ("sum", "avg", "max", "mul", "concat"):
        raise ValueError(f"unknown merge {strategy!r}")
    return merge_lib.merge_stacked(stacked, strategy, live_mask=live)
