"""The flash-attention kernels (CUDA C++, ``csrc/flash_attention.cu``
forward and ``csrc/flash_attention_bwd.cu`` backward) and their wrappers.

``flash_attention_kernel`` replaces the JAX package's Pallas kernel
``_flash_kernel`` (``src/repro/kernels/flash_attention.py:27``, launched by
``flash_attention``): causal or full attention over ``(B, H, S, D)``,
online softmax in f32, output in the input's type.  It reads kv head
``h // (H // Hkv)`` for q head ``h`` (GQA without repeating the kv heads)
and takes strided views, so the model passes its ``(B, S, H, D)``
activations transposed, with no copy.  The source says what bounds it on
an H100 and how its design answers that.  With ``return_lse=True`` it also
writes each row's logsumexp, which the backward reads.

The backward, ``flash_attention_bwd_preprocess_kernel``,
``flash_attention_bwd_dkdv_kernel``, ``flash_attention_bwd_reduce_kernel``
and ``flash_attention_bwd_dq_kernel`` (one launch each per call of
:func:`flash_attention_bwd`), replaces no Pallas kernel: the JAX package
differentiates its plain chunked attention.  Its products run on the
tensor cores as 3xTF32 ``wgmma``, as the forward's do; it is
deterministic (no atomics: the dkdv kernel writes each q head's dK and dV,
the reduce kernel sums each group in head order) and takes the forward's
layouts, head dims and dtypes.  :func:`bwd_plan` reports its tiling and
grids.

:func:`flash_attention` and :func:`flash_attention_bwd` take CUDA tensors
only and raise on anything the kernels do not take; the plain versions
are :func:`repro_torch.kernels.ref.flash_attention` (and
``flash_attention_lse``) and :func:`repro_torch.kernels.ref.
flash_attention_bwd`, and :func:`repro_torch.kernels.ops.flash_attention`
dispatches by device (through :class:`repro_torch.kernels.ops.
FlashAttention` when its inputs require grad).  The library is built by
:mod:`repro_torch.kernels.build` at the first launch.
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
#: the backward's four kernels, in launch order, each counted once per
#: launch, where :func:`flash_attention_bwd` launches them; and the
#: backward's calls by (head dim, dtype)
BWD_KERNELS = ("flash_attention_bwd_preprocess_kernel",
               "flash_attention_bwd_dkdv_kernel",
               "flash_attention_bwd_reduce_kernel",
               "flash_attention_bwd_dq_kernel")
bwd_launches = dict.fromkeys(BWD_KERNELS, 0)
bwd_launches_by_instance = dict.fromkeys(launches_by_instance, 0)


def reset_launches() -> None:
    for counts in (launches, launches_by_instance, bwd_launches,
                   bwd_launches_by_instance):
        for key in counts:
            counts[key] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           **same_as_q: torch.Tensor) -> None:
    """q, k and v as the kernels take them; ``same_as_q`` names further
    tensors of q's shape (the backward's o and do), checked likewise."""
    for name, t in (("q", q), ("k", k), ("v", v), *same_as_q.items()):
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
    for name, t in same_as_q.items():
        if t.shape != q.shape:
            raise ValueError(f"flash_attention kernel: {name} must have q's "
                             f"shape {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
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


def _model_layout(B: int, S: int, H: int, D: int, like: torch.Tensor):
    """An empty ``(B, H, S, D)`` tensor as a view of ``(B, S, H, D)``
    memory, what the model reshapes next."""
    return torch.empty((B, S, H, D), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, return_lse: bool = False):
    """Launch the kernel: q ``(B, H, S, D)``, k and v ``(B, Hkv, S, D)``,
    any strides with a contiguous last dimension.  Returns ``(B, H, S, D)``
    in q's dtype, as a view of ``(B, S, H, D)`` memory (what the model
    reshapes next); with ``return_lse`` also each row's logsumexp of its
    scaled, masked scores, f32 ``(B, H, S)``: ``(out, lse)``.  Launches on
    the current stream without synchronizing; raises on anything the
    kernel does not take and when the launch is refused.  There is no
    fallback."""
    _check(q, k, v)
    B, H, S, D = q.shape
    out = _model_layout(B, S, H, D, q)
    lse = torch.empty((B, H, S), dtype=torch.float32,
                      device=q.device) if return_lse else None
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    stream = build.current_stream(q.device.index)
    code = build.entry("repro_flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), ctypes.addressof(strides),
        DTYPE_CODES[q.dtype], B, H, k.shape[1], S, D, int(bool(causal)),
        q.device.index, stream)
    build.check(code, "flash_attention_kernel")
    launches["flash_attention_kernel"] += 1
    launches_by_instance[(D, q.dtype)] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool):
    """Launch the backward: the forward's q ``(B, H, S, D)``, k and v
    ``(B, Hkv, S, D)``, its output ``o`` and logsumexp ``lse`` (f32
    ``(B, H, S)``, contiguous) and the output's gradient ``do`` (q's
    shape), every tensor but lse in one dtype with a contiguous last
    dimension.  Returns ``(dq, dk, dv)`` in that dtype, each a view of
    ``(B, S, heads, D)`` memory, as the forward's output.  Allocates the
    outputs, the f32 ``(B, H, S)`` scratch for Delta and the f32
    ``(2, B, H, S, D)`` scratch for each q head's dK and dV, launches the
    four kernels on the current stream without synchronizing, and raises
    on anything they do not take and when a launch is refused.  There is
    no fallback."""
    _check(q, k, v, o=o, do=do)
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if not lse.is_cuda or lse.device != q.device or \
            lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, S) or \
            not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd kernel: lse must be a "
                         f"contiguous float32 ({B}, {H}, {S}) tensor on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} "
                         f"on {lse.device}")
    dq = _model_layout(B, S, H, D, q)
    dk, dv = _model_layout(B, S, Hkv, D, q), _model_layout(B, S, Hkv, D, q)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    part = torch.empty((2, B, H, S, D), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    stream = build.current_stream(q.device.index)
    code = build.entry("repro_flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), part.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ctypes.addressof(strides),
        DTYPE_CODES[q.dtype], B, H, Hkv, S, D, int(bool(causal)),
        q.device.index, stream)
    build.check(code, "flash_attention_bwd kernels")
    for name in BWD_KERNELS:
        bwd_launches[name] += 1
    bwd_launches_by_instance[(D, q.dtype)] += 1
    return dq, dk, dv


def bwd_plan(B: int, H: int, Hkv: int, S: int, D: int, dtype: torch.dtype,
             device: torch.device) -> dict:
    """How :func:`flash_attention_bwd` launches a call of this shape on
    the CUDA ``device``, as the library reports it: rows per block (kv
    rows in dkdv, q rows in dq), rows per tile (q tiles in dkdv, kv tiles
    in dq), each block's shared memory, the blocks of each of dkdv and dq
    and their waves over the card's SMs at one block an SM (in f32 every
    block takes more than half of an SM's shared memory), the reduce
    pass's blocks and the heads it sums a kv head, and the longest
    block's tile count."""
    if D not in HEAD_DIMS or dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention_bwd plan: head dim {D}, dtype "
                         f"{dtype}")
    out = (ctypes.c_int * 8)()
    build.check(build.entry("repro_flash_attention_bwd_plan")(
        B, H, Hkv, S, D, DTYPE_CODES[dtype], device.index,
        ctypes.addressof(out)), "flash_attention_bwd plan")
    rows, tile, dkdv_smem, dq_smem, blocks, reduce, longest, sms = out
    return {"block_rows": rows, "tile_rows": tile, "dkdv_smem": dkdv_smem,
            "dq_smem": dq_smem, "blocks": blocks, "sms": sms,
            "waves": blocks / sms, "reduce_blocks": reduce,
            "heads_per_sum": H // Hkv, "longest_tiles": longest}
