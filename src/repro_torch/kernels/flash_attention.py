"""The flash-attention kernel (CUDA C++, ``csrc/flash_attention.cu``) and
its wrapper.

``flash_attention_kernel`` replaces the JAX package's Pallas kernel
``_flash_kernel`` (``src/repro/kernels/flash_attention.py:27``, launched by
``flash_attention``): causal or full attention over ``(B, H, S, D)``,
online softmax in f32, output in the input's type.  It reads kv head
``h // (H // Hkv)`` for q head ``h`` (GQA without repeating the kv heads)
and takes strided views, so the model passes its ``(B, S, H, D)``
activations transposed, with no copy.  The source says what bounds it on
an H100 and how its design answers that.

:func:`flash_attention` takes CUDA tensors only and raises on anything the
kernel does not take; the plain version is
:func:`repro_torch.kernels.ref.flash_attention`, and
:func:`repro_torch.kernels.ops.flash_attention` dispatches by device.  The
library is built by :mod:`repro_torch.kernels.build` at the first launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: one instantiation each: kv tiles of 64 rows up to D = 64, of 32 above
#: (the source's "Head dims" says why)
HEAD_DIMS = (32, 64, 80, 112, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: q rows per block (two warpgroups of 64): the grid's y axis counts these
BLOCK_Q = 128
#: the kernel loads 16 bytes (f32) or 8 bytes (bf16) at a time: every row
#: must start on that boundary
ALIGN_ELEMS = 4

#: kernel launches since the last :func:`reset_launches` — one per launch,
#: counted where the wrapper launches the kernel and nowhere else; the same
#: launches by (head dim, dtype), each an instantiation of its own
launches = {"flash_attention_kernel": 0}
launches_by_instance = {(D, dtype): 0 for D in HEAD_DIMS
                        for dtype in DTYPE_CODES}


def reset_launches() -> None:
    for counts in (launches, launches_by_instance):
        for key in counts:
            counts[key] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, the kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, q on {q.device}")
        if t.dtype not in DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention kernel: {name} dtype {t.dtype} "
                            "(takes float32 or bfloat16, one for q, k and v)")
        if t.ndim != 4:
            raise ValueError(f"flash_attention kernel: {name} must be "
                             f"(B, H, S, D), got shape {tuple(t.shape)}")
        if t.stride(3) != 1 or any(s % ALIGN_ELEMS for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention kernel: {name} must have a contiguous last "
                f"dimension, other strides that are multiples of "
                f"{ALIGN_ELEMS} and a 16-byte aligned start; got strides "
                f"{t.stride()}")
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} (takes "
                         f"{HEAD_DIMS})")
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, S, D) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"flash_attention kernel: k and v must be (B, Hkv, S, D) = "
            f"({B}, Hkv, {S}, {D}), got {tuple(k.shape)} and "
            f"{tuple(v.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention kernel: {H} q heads do not split "
                         f"into groups over {Hkv} kv heads")
    if S < 1 or -(-S // BLOCK_Q) > 65535 or B * H > 2 ** 31 - 1:
        raise ValueError(f"flash_attention kernel: shape {tuple(q.shape)} "
                         "is outside the launch grid")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Launch the kernel: q ``(B, H, S, D)``, k and v ``(B, Hkv, S, D)``,
    any strides with a contiguous last dimension.  Returns ``(B, H, S, D)``
    in q's dtype, as a view of ``(B, S, H, D)`` memory (what the model
    reshapes next).  Launches on the current stream without synchronizing;
    raises on anything the kernel does not take and when the launch is
    refused.  There is no fallback."""
    _check(q, k, v)
    B, H, S, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    stream = build.current_stream(q.device.index)
    code = build.entry("repro_flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), DTYPE_CODES[q.dtype], B, H, k.shape[1], S,
        D, int(bool(causal)), q.device.index, stream)
    build.check(code, "flash_attention_kernel")
    launches["flash_attention_kernel"] += 1
    launches_by_instance[(D, q.dtype)] += 1
    return out
