"""The fused K-client cut-layer merge and its backward (the paper's
jacobian splitting): four CUDA C++ kernels for Hopper, in
``csrc/merge_pool.cu``.

:func:`merge_pool` launches the two forward kernels, :func:`merge_pool_bwd`
and :func:`concat_bwd` the two backward kernels, on CUDA tensors only,
through ``ctypes`` from the library that :mod:`repro_torch.kernels.build`
makes.  The source says what bounds each kernel and how its design
answers that:

``merge_reduce_kernel`` replaces the JAX package's Pallas kernel
``_merge_kernel`` (``src/repro/kernels/merge_pool.py:29``, launched by
``_merge_pool_fwd_call``): the masked K-way sum / avg / max / mul of a
``(K, B, D)`` stack into ``(B, D)``, accumulated in f32.  avg divides by
``max(sum(live), 1)``; max takes ``-3e38`` for a dropped client and gives
zeros when every client is dropped; mul takes 1 for a dropped client.

``merge_reduce_bwd_kernel`` replaces ``_merge_bwd_kernel``
(``src/repro/kernels/merge_pool.py:144``, launched by
``_merge_pool_bwd_call``): from the merged gradient ``g (B, D)`` it writes
every client's ``dx_k (B, D)``, in ``g``'s dtype, formed in f32 as
:func:`repro_torch.kernels.ref.merge_pool_bwd` forms it:

* sum: ``g * l_k``; avg: ``g * (l_k / max(sum(live), 1))`` — ``g`` and the
  live flags only, neither the stack nor the forward output is read;
* max: ``g / ties`` where ``x_k == out`` and client k is live, else 0
  (``ties`` counts the live clients holding the maximum, so tied clients
  split the credit, as autodiff of ``amax`` does);
* mul: ``g`` times the product of the OTHER live clients (prefix times
  suffix, a dropped client selected to 1).  The Pallas kernel computes
  ``g * out / x_k``, which is 0/0 at a live ``x_k == 0``; the exclusive
  product is what autodiff of ``torch.prod`` / ``jnp.prod`` gives there,
  and the port is held to that.

``merge_concat_kernel`` replaces ``_concat_kernel``
(``src/repro/kernels/merge_pool.py:67``, launched by ``_concat_fwd_call``):
client k's ``(B, D)`` slice lands in columns ``k*D .. (k+1)*D`` of the
``(B, K*D)`` output, times ``live[k]``.

``merge_concat_bwd_kernel`` replaces ``_concat_bwd_kernel``
(``src/repro/kernels/merge_pool.py:96``, launched by
``_concat_bwd_call``): ``dx_k = g[:, k*D:(k+1)*D] * l_k``.

Both concat directions multiply a dropped client's values by its 0 flag
rather than skip them, so a NaN there gives NaN, as the plain merge does.

The four share one host path, kept lean because the kernels take a few
microseconds on the device: the checks, ``new_empty`` for the output,
then :func:`_launch`, which calls the C entry point (resolved once by
:func:`repro_torch.kernels.build.entry`) with the raw pointers, the device
index and the raw current stream, and raises on a returned CUDA error.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

STRATEGY_CODES = {"sum": 0, "avg": 1, "max": 2, "mul": 3}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last :func:`reset_launches` — one per launch,
#: counted where the wrapper launches the kernel and nowhere else
launches = {"merge_reduce_kernel": 0, "merge_concat_kernel": 0,
            "merge_reduce_bwd_kernel": 0, "merge_concat_bwd_kernel": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_tensor(t: torch.Tensor, what: str, shape: Optional[tuple] = None,
                  dtype: Optional[torch.dtype] = None) -> None:
    """A kernel operand: a contiguous float32/bfloat16 CUDA tensor (of
    ``shape`` and ``dtype``, when given) that int32 offsets can address."""
    if not t.is_cuda:
        raise ValueError(f"merge_pool kernel: {what} is on {t.device}, "
                         "the kernel takes CUDA tensors only")
    if t.dtype not in DTYPE_CODES or (dtype is not None and t.dtype != dtype):
        raise TypeError(f"merge_pool kernel: {what} dtype {t.dtype} "
                        "(takes float32 or bfloat16, one for all operands)")
    if shape is not None and t.shape != shape:
        raise ValueError(f"merge_pool kernel: {what} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"merge_pool kernel: {what} must be contiguous")
    if t.numel() >= 2 ** 31 - 1:
        raise ValueError("merge_pool kernel: int32 offsets cannot address "
                         f"{t.numel()} elements")


def _check_live(live: torch.Tensor, k: int, like: torch.Tensor) -> None:
    """``live``: a contiguous ``(k,)`` float32 tensor on ``like``'s card."""
    if (live.get_device() != like.get_device() or live.dtype != torch.float32
            or live.shape != (k,) or not live.is_contiguous()):
        raise ValueError(f"merge_pool kernel: live must be a contiguous ({k},) "
                         f"float32 tensor on {like.device}, got "
                         f"{tuple(live.shape)} {live.dtype} on {live.device}")


def _check(stacked: torch.Tensor, live: torch.Tensor,
           strategy: str) -> torch.Size:
    """The forward's operands; returns the stack's ``(K, B, D)``."""
    if strategy not in STRATEGY_CODES and strategy != "concat":
        raise ValueError(f"unknown merge {strategy!r}")
    shape = stacked.shape
    if len(shape) != 3:
        raise ValueError(f"merge_pool kernel: stacked must be (K, B, D), got "
                         f"shape {tuple(shape)}")
    _check_tensor(stacked, "stacked")
    _check_live(live, shape[0], stacked)
    return shape


def _check_concat_bwd(live: torch.Tensor, g: torch.Tensor,
                      k: int) -> tuple[int, int]:
    """The concat backward's operands; returns ``(B, D)``."""
    shape = g.shape
    if len(shape) != 2 or shape[1] % k:
        raise ValueError(f"merge_pool kernel: g must be (B, {k}*D), got "
                         f"shape {tuple(shape)}")
    _check_tensor(g, "g")
    _check_live(live, k, g)
    return shape[0], shape[1] // k


def _launch(kernel: str, entry: str, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` (its arguments up to
    the device index, which comes last) and the device's current stream;
    raise on a CUDA error, else count one launch of ``kernel``."""
    code = build.entry(entry)(*args, build.current_stream(args[-1]))
    build.check(code, kernel)
    launches[kernel] += 1


def merge_pool(stacked: torch.Tensor, live: Optional[torch.Tensor] = None, *,
               strategy: str = "avg") -> torch.Tensor:
    """Launch the merge kernel on a CUDA ``(K, B, D)`` stack; ``live`` is a
    ``(K,)`` float32 mask (None = all live).  Returns ``(B, D)`` for the
    reductions, ``(B, K*D)`` for concat, from the CUDA C++ kernels on the
    current stream.  Raises on anything the kernels do not take and when a
    launch is refused; there is no fallback."""
    if live is None:
        live = torch.ones((stacked.shape[0],), dtype=torch.float32,
                          device=stacked.device)
    elif live.dtype != torch.float32:
        live = live.to(torch.float32)
    K, B, D = _check(stacked, live, strategy)
    if strategy == "concat":
        out = stacked.new_empty((B, K * D))
        _launch("merge_concat_kernel", "repro_merge_concat",
                stacked.data_ptr(), live.data_ptr(), out.data_ptr(), B, D, K,
                DTYPE_CODES[stacked.dtype], stacked.get_device())
        return out
    out = stacked.new_empty((B, D))
    _launch("merge_reduce_kernel", "repro_merge_reduce", stacked.data_ptr(),
            live.data_ptr(), out.data_ptr(), B * D, K,
            STRATEGY_CODES[strategy], DTYPE_CODES[stacked.dtype],
            stacked.get_device())
    return out


def merge_pool_bwd(stacked: Optional[torch.Tensor], live: torch.Tensor,
                   out: Optional[torch.Tensor], g: torch.Tensor, *,
                   strategy: str) -> torch.Tensor:
    """Launch the reduction backward on CUDA: ``g`` is the merged output's
    ``(B, D)`` gradient, already in the stack's dtype and contiguous;
    ``live`` the ``(K,)`` float32 mask.  ``stacked`` (K, B, D) is read by
    max and mul, ``out`` (the forward output) by max; pass None where the
    strategy does not read it.  Returns ``dx (K, B, D)`` in ``g``'s dtype,
    from the CUDA C++ kernel on the current stream.  Raises on anything
    the kernel does not take; there is no fallback."""
    if strategy not in STRATEGY_CODES:
        raise ValueError(f"unknown merge {strategy!r} for the reduction "
                         "backward")
    K = live.shape[0]
    if g.ndim != 2:
        raise ValueError(f"merge_pool kernel: g must be (B, D), got shape "
                         f"{tuple(g.shape)}")
    B, D = g.shape
    _check_tensor(g, "g", (B, D))
    _check_live(live, K, g)
    if strategy in ("max", "mul"):
        if stacked is None:
            raise ValueError(f"merge_pool kernel: the {strategy} backward "
                             "reads the stack")
        _check_tensor(stacked, "stacked", (K, B, D), g.dtype)
    if strategy == "max":
        if out is None:
            raise ValueError("merge_pool kernel: the max backward reads the "
                             "forward output")
        _check_tensor(out, "out", (B, D), g.dtype)
    dx = g.new_empty((K, B, D))
    # sum/avg never read the stack, mul never the output: null for those
    _launch("merge_reduce_bwd_kernel", "repro_merge_reduce_bwd",
            g.data_ptr(), live.data_ptr(),
            stacked.data_ptr() if strategy in ("max", "mul") else None,
            out.data_ptr() if strategy == "max" else None, dx.data_ptr(),
            B * D, K, STRATEGY_CODES[strategy], DTYPE_CODES[g.dtype],
            g.get_device())
    return dx


def concat_bwd(live: torch.Tensor, g: torch.Tensor, *, k: int) -> torch.Tensor:
    """Launch the concat backward on CUDA: ``g`` is the merged output's
    ``(B, k*D)`` gradient, contiguous; returns ``dx (k, B, D)`` in ``g``'s
    dtype, from the CUDA C++ kernel on the current stream.  Raises on
    anything the kernel does not take; there is no fallback."""
    B, D = _check_concat_bwd(live, g, k)
    dx = g.new_empty((k, B, D))
    _launch("merge_concat_bwd_kernel", "repro_merge_concat_bwd",
            live.data_ptr(), g.data_ptr(), dx.data_ptr(), B, D, k,
            DTYPE_CODES[g.dtype], g.get_device())
    return dx
