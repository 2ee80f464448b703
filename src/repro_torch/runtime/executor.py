"""Role-0 merge fast path (the training ``Executor`` comes with the training
slice)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def fast_merge(stacked: torch.Tensor, strategy: str, *,
               use_kernel: bool = True) -> torch.Tensor:
    """merge_pool for every strategy — the fused kernel on CUDA (reductions
    AND the gather-concat), the plain version on the CPU.

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
