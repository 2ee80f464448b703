"""Dispatch by the tensor's device: the plain PyTorch version for a CPU
tensor, the hand-written kernel for a CUDA tensor (or an exception — there
is no fallback from the kernel to the plain version).

:class:`MergePool` makes the merge differentiable on every device: its
forward and backward launch the four CUDA C++ merge kernels on CUDA and
run the plain versions of :mod:`repro_torch.kernels.ref` on the CPU, the
port's counterpart of the JAX package's ``custom_vjp`` around the Pallas
calls.
:class:`SSDChunk` does the same for the SSD chunk terms: the CUDA
forward and backward kernels on CUDA, the plain versions on the CPU (the
Pallas SSD kernel has no backward; the JAX package differentiates its
plain scan).  :class:`FlashAttention` does the same for attention: the
flash kernel forward (writing each row's logsumexp) and the hand-written
flash backward kernels on CUDA, ``ref.flash_attention_lse`` and
``ref.flash_attention_bwd`` on the CPU (the Pallas flash kernel has no
backward either; the JAX model differentiates its plain chunked
attention).  :func:`flash_attention` takes it only when an input
requires grad; serving launches the forward alone.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import merge_pool as merge_pool_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd_kernel

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


class SSDChunk(torch.autograd.Function):
    """The SSD scan's chunk terms, ``(xdt, a, B, C) -> (y_intra, state,
    decay, cum)`` in the layouts of :func:`ref.ssd_chunks`, differentiable
    on every device: ``ssd_chunk_kernel`` forward and
    ``ssd_chunk_bwd_kernel`` backward on CUDA, the plain versions on the
    CPU.  Saves the four inputs; the backward recomputes the rest.  decay
    is marked non-differentiable (:func:`ssd_scan` reads cum instead), and
    an output whose gradient is absent reaches the backward as None."""

    @staticmethod
    def forward(ctx, xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int):
        fwd = ssd_kernel.ssd_chunk if xdt.is_cuda else ref.ssd_chunks
        y, state, decay, cum = fwd(xdt, a, Bm, Cm, chunk)
        ctx.chunk = chunk
        ctx.save_for_backward(xdt, a, Bm, Cm)
        ctx.mark_non_differentiable(decay)
        ctx.set_materialize_grads(False)
        return y, state, decay, cum

    @staticmethod
    def backward(ctx, gy, gstate, _gdecay, gcum):
        xdt, a, Bm, Cm = ctx.saved_tensors
        bwd = ssd_kernel.ssd_chunk_bwd if xdt.is_cuda else ref.ssd_chunks_bwd
        dx, da, dB, dC = bwd(xdt, a, Bm, Cm, gy, gstate, gcum, ctx.chunk)
        return dx, da, dB, dC, None


class FlashAttention(torch.autograd.Function):
    """Attention over q ``(B, H, S, D)``, k and v ``(B, Hkv, S, D)``,
    differentiable on every device: ``flash_attention_kernel`` with its
    logsumexp forward and the four ``flash_attention_bwd_*`` kernels
    backward on CUDA, ``ref.flash_attention_lse`` and
    ``ref.flash_attention_bwd`` on the CPU.  Saves q, k, v, the output and
    the logsumexp (f32 ``(B, H, S)``); the backward recomputes the
    scores."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> torch.Tensor:
        if q.is_cuda:
            o, lse = flash_kernel.flash_attention(q, k, v, causal=causal,
                                                  return_lse=True)
        else:
            o, lse = ref.flash_attention_lse(q, k, v, causal=causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v, o, lse = ctx.saved_tensors
        # the gradient arrives in the output's dtype, possibly strided; the
        # kernel takes a contiguous last dimension and 16-byte rows
        do = do.to(q.dtype)
        if do.is_cuda:
            if do.stride(-1) != 1 or do.data_ptr() % 16 or any(
                    s % flash_kernel.ALIGN_ELEMS for s in do.stride()[:-1]):
                do = do.contiguous()
            dq, dk, dv = flash_kernel.flash_attention_bwd(
                q, k, v, o, lse, do, causal=ctx.causal)
        else:
            dq, dk, dv = ref.flash_attention_bwd(q, k, v, o, lse, do,
                                                 causal=ctx.causal)
        return dq, dk, dv, None


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
    plain version for CPU tensors, the CUDA kernel for CUDA tensors.  A
    call whose inputs require grad goes through :class:`FlashAttention`
    (on CUDA: the forward with its logsumexp, then the backward kernels);
    one without (serving) runs the forward alone."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal)
    return flash_kernel.flash_attention(q, k, v, causal=causal)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             initial_state: Optional[torch.Tensor] = None):
    """The full SSD scan through the chunk kernel plus the host's
    inter-chunk recurrence: the JAX package's ``ops.ssd_scan``.

    x ``(B, S, H, P)``, dt ``(B, S, H)``, A ``(H,)``, Bm and Cm
    ``(B, S, 1, N)`` (one group).  Returns y ``(B, S, H, P)`` and the final
    state ``(B, H, P, N)``, both f32.  The chunk terms go through
    :class:`SSDChunk`: the CUDA kernels for CUDA tensors, forward and
    backward, and the plain versions for CPU tensors.  The pre-scaling,
    the inter-chunk recurrence and y_off are plain differentiable torch
    ops, which autograd differentiates as ``jax.grad`` does the JAX
    package's.

    Raises on ``n_groups != 1`` (the chunk kernel shares one B/C across the
    heads, as the Pallas host side does), on a chunk that does not divide
    S and on any device other than the CPU and CUDA."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if G != 1:
        raise NotImplementedError(
            f"ssd_scan: n_groups = {G}; the chunk kernel takes one group "
            "(use the model's ssd_chunked for grouped B/C)")
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_scan: chunk {Q} does not divide the sequence "
                         f"length {S}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: no kernel for device {x.device}")
    nc = S // Q
    a = (dt * A[None, None, :]).to(torch.float32)
    xdt = (x * dt[..., None]).to(torch.float32)
    Bs = Bm[:, :, 0].to(torch.float32)
    Cs = Cm[:, :, 0].to(torch.float32)
    y_intra, states, _, cums = SSDChunk.apply(xdt, a, Bs, Cs, Q)

    # inter-chunk recurrence (the JAX package's lax.scan carry) as one
    # product over the chunks, Mamba2's chunk-level segsum: with l_0 = 0
    # and l_c the log-decay of chunk c - 1, the state entering chunk z
    # (z = nc: the final state) is sum_{c <= z} exp(l_{c+1} + ... + l_z)
    # s_c over s = [initial_state, chunk 0's state, ...].  Each exponent
    # is summed term by term under a mask, not taken as a difference of
    # running sums, which would lose digits over many chunks.
    ell = torch.nn.functional.pad(
        cums.reshape(Bsz, nc, Q, H)[:, :, -1].transpose(1, 2), (1, 0))
    T = nc + 1
    ones = torch.ones((T, T), dtype=torch.bool, device=x.device)
    seg = torch.cumsum(ell[..., :, None].masked_fill(~ones.tril(-1), 0.0),
                       dim=-2)
    decay = torch.exp(seg.masked_fill(~ones.tril(), float("-inf")))
    entering = torch.einsum("bhzc,bchq->bzhq", decay[..., 1:],
                            states.reshape(Bsz, nc, H, P * N))
    if initial_state is not None:
        entering = entering + torch.einsum(
            "bhz,bhq->bzhq", decay[..., 0],
            initial_state.to(torch.float32).reshape(Bsz, H, P * N))
    # y_off = exp(cum) * (C . state_in): one batched product per (batch,
    # chunk) whose output (Q, H * P) is already the sequence layout
    y_off = torch.matmul(
        Cs.reshape(Bsz, nc, Q, N),
        entering[:, :nc].reshape(Bsz, nc, H * P, N).transpose(-1, -2))
    y = y_intra + y_off.reshape(Bsz, S, H, P) * torch.exp(cums)[..., None]
    return y, entering[:, nc].reshape(Bsz, H, P, N)
