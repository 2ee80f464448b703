"""Triton kernels for Hopper: the fused K-client cut-layer merge, forward.

Two kernels, both launched by :func:`merge_pool` on CUDA tensors only:

``merge_reduce_kernel`` replaces the JAX package's Pallas kernel
``_merge_kernel`` (``src/repro/kernels/merge_pool.py:29``, launched by
``_merge_pool_fwd_call``): the masked K-way sum / avg / max / mul of a
``(K, B, D)`` stack into ``(B, D)``, accumulated in f32.  avg divides by
``max(sum(live), 1)``; max takes ``-3e38`` for a dropped client and gives
zeros when every client is dropped; mul takes 1 for a dropped client.

``merge_concat_kernel`` replaces ``_concat_kernel``
(``src/repro/kernels/merge_pool.py:67``, launched by ``_concat_fwd_call``):
client k's ``(B, D)`` slice lands in columns ``k*D .. (k+1)*D`` of the
``(B, K*D)`` output, times ``live[k]``.

Bound on an H100 SXM: both are pure data movement with a handful of flops
per element, so the bound is bytes over the 3.35 TB/s of device memory —
``(K*B*D + B*D) * itemsize`` for the reduction and
``(K*B*D + B*K*D) * itemsize`` for the concat (plus the ``K`` f32 live
flags).  The design moves exactly those bytes: each program loads its
``(BLOCK_B, BLOCK_D)`` tile of every client once, keeps the running
reduction in registers (K is a compile-time constant, the client loop is
unrolled), and stores the merged tile once; nothing is kept in between.
The grid is ``(B-tiles, D-tiles)`` (plus the client axis for concat);
blocks run in parallel in any order, so nothing carries from one program
to the next.  Ragged edges (D = 960 is not a power of two, decode has
B = 1) are masked, so no tile width has to divide D.

``triton`` is imported at the first launch, not when this module is
imported: the CPU tests import every module, and the CPU has no Triton.
Its compile cache goes to ``build/triton/`` in the checkout unless
``TRITON_CACHE_DIR`` is already set.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

STRATEGY_CODES = {"sum": 0, "avg": 1, "max": 2, "mul": 3}
BLOCK_B_MAX = 32
BLOCK_D_MAX = 128
NUM_WARPS = 4
TRITON_CACHE_DIR = Path(__file__).resolve().parents[3] / "build" / "triton"

#: kernel launches since the last :func:`reset_launches` — one per launch,
#: counted where the wrapper launches the kernel and nowhere else
launches = {"merge_reduce_kernel": 0, "merge_concat_kernel": 0}

# ``triton.language``: bound by _compiled() at the first launch.  The
# kernel bodies below resolve ``tl`` from this module's globals when Triton
# compiles them, which happens after that binding.
tl = None
_KERNELS: Optional[dict] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def merge_reduce_kernel(x_ptr, live_ptr, out_ptr, B, D, stride_k,
                        K: tl.constexpr, STRATEGY: tl.constexpr,
                        BLOCK_B: tl.constexpr, BLOCK_D: tl.constexpr):
    """One (BLOCK_B, BLOCK_D) tile of the masked K-way reduction.
    STRATEGY: 0 sum, 1 avg, 2 max, 3 mul (STRATEGY_CODES)."""
    rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
    cols = tl.program_id(1) * BLOCK_D + tl.arange(0, BLOCK_D)
    mask = (rows[:, None] < B) & (cols[None, :] < D)
    offs = rows[:, None] * D + cols[None, :]

    total = tl.load(live_ptr)
    blk = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    if STRATEGY <= 1:
        acc = blk * total
    elif STRATEGY == 2:
        acc = tl.where(total > 0, blk, -3.0e38)
    else:
        acc = tl.where(total > 0, blk, 1.0)
    for i in tl.static_range(1, K):  # K is small and static: unrolled
        live = tl.load(live_ptr + i)
        total += live
        blk = tl.load(x_ptr + i * stride_k + offs, mask=mask,
                      other=0.0).to(tl.float32)
        if STRATEGY <= 1:
            acc += blk * live
        elif STRATEGY == 2:
            acc = tl.maximum(acc, tl.where(live > 0, blk, -3.0e38))
        else:
            acc *= tl.where(live > 0, blk, 1.0)
    if STRATEGY == 1:
        acc = acc / tl.maximum(total, 1.0)
    if STRATEGY == 2:
        # every client dropped -> zeros, not -3e38
        acc = tl.where(total > 0, acc, 0.0)
    tl.store(out_ptr + offs, acc.to(out_ptr.dtype.element_ty), mask=mask)


def merge_concat_kernel(x_ptr, live_ptr, out_ptr, B, D, stride_k,
                        K: tl.constexpr, BLOCK_B: tl.constexpr,
                        BLOCK_D: tl.constexpr):
    """Client program_id(2)'s (BLOCK_B, BLOCK_D) tile, times its live
    flag, into its column block of the (B, K*D) output."""
    k = tl.program_id(2)
    rows = tl.program_id(0) * BLOCK_B + tl.arange(0, BLOCK_B)
    cols = tl.program_id(1) * BLOCK_D + tl.arange(0, BLOCK_D)
    mask = (rows[:, None] < B) & (cols[None, :] < D)
    live = tl.load(live_ptr + k)
    blk = tl.load(x_ptr + k * stride_k + rows[:, None] * D + cols[None, :],
                  mask=mask, other=0.0)
    out = blk.to(tl.float32) * live
    tl.store(out_ptr + rows[:, None] * (K * D) + k * D + cols[None, :],
             out.to(out_ptr.dtype.element_ty), mask=mask)


def _compiled() -> dict:
    """JIT-wrap the kernels (Triton compiles each specialization at its
    first launch and caches it under TRITON_CACHE_DIR)."""
    global _KERNELS, tl
    if _KERNELS is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(TRITON_CACHE_DIR))
        import triton
        import triton.language

        tl = triton.language
        _KERNELS = {"reduce": triton.jit(merge_reduce_kernel),
                    "concat": triton.jit(merge_concat_kernel)}
    return _KERNELS


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _check(stacked: torch.Tensor, live: torch.Tensor, strategy: str) -> None:
    if strategy not in STRATEGY_CODES and strategy != "concat":
        raise ValueError(f"unknown merge {strategy!r}")
    if not stacked.is_cuda:
        raise ValueError(f"merge_pool kernel: stacked is on {stacked.device}, "
                         "the kernel takes CUDA tensors only")
    if stacked.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"merge_pool kernel: dtype {stacked.dtype} "
                        "(takes float32 or bfloat16)")
    if stacked.ndim != 3:
        raise ValueError(f"merge_pool kernel: stacked must be (K, B, D), got "
                         f"shape {tuple(stacked.shape)}")
    if not stacked.is_contiguous():
        raise ValueError("merge_pool kernel: stacked must be contiguous")
    if stacked.numel() >= 2 ** 31 - 1:
        raise ValueError("merge_pool kernel: int32 offsets cannot address "
                         f"{stacked.numel()} elements")
    K = stacked.shape[0]
    if (live.device != stacked.device or live.dtype != torch.float32
            or tuple(live.shape) != (K,) or not live.is_contiguous()):
        raise ValueError(f"merge_pool kernel: live must be a contiguous ({K},) "
                         f"float32 tensor on {stacked.device}, got "
                         f"{tuple(live.shape)} {live.dtype} on {live.device}")


def merge_pool(stacked: torch.Tensor, live: Optional[torch.Tensor] = None, *,
               strategy: str = "avg") -> torch.Tensor:
    """Launch the merge kernel on a CUDA ``(K, B, D)`` stack; ``live`` is a
    ``(K,)`` float32 mask (None = all live).  Returns ``(B, D)`` for the
    reductions, ``(B, K*D)`` for concat.  Raises on anything the kernel
    does not take; there is no fallback."""
    if live is None:
        live = torch.ones((stacked.shape[0],), dtype=torch.float32,
                          device=stacked.device)
    live = live.to(torch.float32)
    _check(stacked, live, strategy)
    kernels = _compiled()
    K, B, D = stacked.shape
    block_b = min(BLOCK_B_MAX, _next_pow2(B))
    block_d = min(BLOCK_D_MAX, _next_pow2(D))
    tiles = ((B + block_b - 1) // block_b, (D + block_d - 1) // block_d)
    with torch.cuda.device(stacked.device):
        if strategy == "concat":
            out = torch.empty((B, K * D), dtype=stacked.dtype,
                              device=stacked.device)
            kernels["concat"][tiles + (K,)](
                stacked, live, out, B, D, B * D, K=K, BLOCK_B=block_b,
                BLOCK_D=block_d, num_warps=NUM_WARPS)
            launches["merge_concat_kernel"] += 1
        else:
            out = torch.empty((B, D), dtype=stacked.dtype,
                              device=stacked.device)
            kernels["reduce"][tiles](
                stacked, live, out, B, D, B * D, K=K,
                STRATEGY=STRATEGY_CODES[strategy], BLOCK_B=block_b,
                BLOCK_D=block_d, num_warps=NUM_WARPS)
            launches["merge_reduce_kernel"] += 1
    return out
