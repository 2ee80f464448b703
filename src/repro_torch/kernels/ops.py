"""Dispatch by the tensor's device: the plain PyTorch version for a CPU
tensor, the hand-written kernel for a CUDA tensor (or an exception — there
is no fallback from the kernel to the plain version).

:class:`MergePool` makes the merge differentiable on every device: its
forward and backward launch the Triton kernels on CUDA and run the plain
versions of :mod:`repro_torch.kernels.ref` on the CPU, the port's
counterpart of the JAX package's ``custom_vjp`` around the Pallas calls.
:func:`flash_attention` is forward-only, as the Pallas kernel is.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import merge_pool as merge_pool_kernel
from repro_torch.kernels import ref

STRATEGIES = ("sum", "avg", "max", "mul", "concat")


class MergePool(torch.autograd.Function):
    """``stacked (K, B, D)``, ``live (K,)`` float32 -> the merge; the
    gradient flows to ``stacked`` only (the live mask is not
    differentiable).  Saves only what the strategy's backward reads: the
    live mask, plus the stack for max and mul, plus the output for max."""

    @staticmethod
    def forward(ctx, stacked: torch.Tensor, live: torch.Tensor,
                strategy: str) -> torch.Tensor:
        if stacked.is_cuda:
            out = merge_pool_kernel.merge_pool(stacked, live,
                                               strategy=strategy)
        else:
            out = ref.merge_pool(stacked, strategy, live)
        ctx.strategy = strategy
        ctx.k = stacked.shape[0]
        ctx.dtype = stacked.dtype
        ctx.save_for_backward(
            live, stacked if strategy in ("max", "mul") else None,
            out if strategy == "max" else None)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        live, stacked, out = ctx.saved_tensors
        # the gradient arrives in the output's dtype, possibly strided
        # (through fast_merge's reshape or a broadcast); the kernels take
        # it contiguous and in the stack's dtype, as the Pallas _bwd casts
        g = g.to(ctx.dtype).contiguous()
        if ctx.strategy == "concat":
            if g.is_cuda:
                dx = merge_pool_kernel.concat_bwd(live, g, k=ctx.k)
            else:
                dx = ref.concat_bwd(live, g, ctx.k)
        elif g.is_cuda:
            dx = merge_pool_kernel.merge_pool_bwd(stacked, live, out, g,
                                                  strategy=ctx.strategy)
        else:
            dx = ref.merge_pool_bwd(stacked, live, out, g, ctx.strategy)
        return dx, None, None


def merge_pool(stacked: torch.Tensor, live: Optional[torch.Tensor] = None, *,
               strategy: str = "avg", use_kernel: bool = True) -> torch.Tensor:
    """Differentiable merge of a ``(K, B, D)`` stack through
    :class:`MergePool`.  ``use_kernel=False`` runs the plain version (with
    PyTorch's own autograd) on any device, for runs that compare the two."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown merge {strategy!r}")
    if not use_kernel:
        return ref.merge_pool(stacked, strategy, live)
    if stacked.device.type not in ("cpu", "cuda"):
        raise ValueError(f"merge_pool: no kernel for device {stacked.device}")
    if live is None:
        live = torch.ones((stacked.shape[0],), dtype=torch.float32,
                          device=stacked.device)
    return MergePool.apply(stacked, live.to(torch.float32), strategy)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Attention over q ``(B, H, S, D)``, k and v ``(B, Hkv, S, D)``: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors.

    The kernel has no backward (nor has the Pallas kernel: the JAX model
    differentiates its plain chunked path), so on CUDA a call whose inputs
    require grad raises rather than return a result that autograd cannot
    follow."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention: the CUDA kernel is forward-only; training past "
            "2048 tokens (a backward kernel) comes with a later training "
            "slice of the port")
    return flash_kernel.flash_attention(q, k, v, causal=causal)
