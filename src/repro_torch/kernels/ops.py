"""Dispatch by the tensor's device: the plain PyTorch version for a CPU
tensor, the hand-written kernel for a CUDA tensor (or an exception — there
is no fallback from the kernel to the plain version)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import merge_pool as merge_pool_kernel
from repro_torch.kernels import ref


def merge_pool(stacked: torch.Tensor, live: Optional[torch.Tensor] = None, *,
               strategy: str = "avg", use_kernel: bool = True) -> torch.Tensor:
    """``use_kernel=False`` runs the plain version on any device (for runs
    that compare the two)."""
    if stacked.device.type == "cpu" or not use_kernel:
        return ref.merge_pool(stacked, strategy, live)
    if stacked.is_cuda:
        return merge_pool_kernel.merge_pool(stacked, live, strategy=strategy)
    raise ValueError(f"merge_pool: no kernel for device {stacked.device}")
