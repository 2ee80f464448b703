"""The Mamba2 SSD chunk kernel (CUDA C++, ``csrc/ssd_chunk.cu``), its
backward (``csrc/ssd_chunk_bwd.cu``) and their wrappers.

``ssd_chunk_kernel`` replaces the JAX package's Pallas kernel
``_ssd_chunk_kernel`` (``src/repro/kernels/ssd_scan.py:23``, launched by
``ssd_chunk_batch``): the quadratic intra-chunk term of the SSD scan, its
per-chunk state and decay and the running log-decay, in f32.  It reads the
model's tensors by strides — x ``(B, S, H, P)``, a ``(B, S, H)``, and B/C
``(B, S, N)`` shared by every head (one group) — so the host side makes no
transposed or head-broadcast copy.

On an H100 the function is bound by its bytes: 1.661 GB at the server
shape ``(1, 32768, 64 heads, P 64, N 128, Q 128)``, 0.496 ms at
3.35 TB/s, against 0.319 ms for its 52.6 GFLOP as 3xTF32 on the tensor
cores (0.785 ms as f32 FMA).  So the kernel runs all three products — C
B^T, the masked and decay-weighted S_h x_h, and the state — as 3xTF32
``wgmma`` (f32 accuracy, held to 3e-4), and computes C B^T once per block
of HG heads (:func:`plan` reports HG and the block count).  The source
says how.

``ssd_chunk_bwd_kernel`` has no Pallas counterpart (the JAX package
differentiates its plain chunked scan): it computes the gradients of x,
a, B and C from the forward's inputs and the upstream gradients, every
product as 3xTF32 ``wgmma`` on the tensor cores, one block per (chunk,
group of HG heads, batch) as the forward cuts it (:func:`bwd_plan`).  The
block computes C B^T once for its heads and forms its group's partials of
dB and dC from the head-summed terms; ``ssd_chunk_bwd_reduce_kernel``
sums the groups' partials in order.  At the training shape the function
is about as much bytes as operations (0.042 ms vs 0.040 ms on an H100).

:func:`ssd_chunk` and :func:`ssd_chunk_bwd` take CUDA tensors only and
raise on anything the kernels do not take; the plain versions are
:func:`repro_torch.kernels.ref.ssd_chunks` and
:func:`~repro_torch.kernels.ref.ssd_chunks_bwd`, and
:func:`repro_torch.kernels.ops.ssd_scan` dispatches by device through
:class:`~repro_torch.kernels.ops.SSDChunk`.  The library
is built by :mod:`repro_torch.kernels.build` at the first launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64)
#: a block takes one chunk in two warpgroups of 64 rows
MAX_CHUNK = 128
#: d_state runs in tensor-core k-steps of 8, staged 16 columns at a time
STATE_MULTIPLE = 16
GRID_LIMIT = 65535  # head groups and batch ride the grid's y and z axes

#: kernel launches since the last :func:`reset_launches` — one per launch,
#: counted where the wrapper launches the kernel and nowhere else
#: (``ssd_chunk_bwd_kernel``: one per call of :func:`ssd_chunk_bwd`, which
#: launches the kernel and its reduce pass over the head groups)
launches = {"ssd_chunk_kernel": 0, "ssd_chunk_bwd_kernel": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_tensors(kernel: str, ref: torch.Tensor, named) -> None:
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the kernel "
                             "takes CUDA tensors only")
        if t.device != ref.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, xdt on "
                             f"{ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} dtype {t.dtype} (takes "
                            "float32)")


def _check(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, chunk: int) -> None:
    _check_tensors("ssd_chunk kernel", xdt,
                   (("xdt", xdt), ("a", a), ("B", Bm), ("C", Cm)))
    if xdt.ndim != 4:
        raise ValueError("ssd_chunk kernel: xdt must be (B, S, H, P), got "
                         f"shape {tuple(xdt.shape)}")
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    if tuple(a.shape) != (B, S, H) or Bm.ndim != 3 or \
            tuple(Bm.shape[:2]) != (B, S) or tuple(Cm.shape) != tuple(
                Bm.shape):
        raise ValueError(
            f"ssd_chunk kernel: a must be (B, S, H) = ({B}, {S}, {H}) and B, "
            f"C (B, S, N); got {tuple(a.shape)}, {tuple(Bm.shape)}, "
            f"{tuple(Cm.shape)}")
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_chunk kernel: head dim {P} (takes "
                         f"{HEAD_DIMS})")
    if N < STATE_MULTIPLE or N % STATE_MULTIPLE:
        raise ValueError(f"ssd_chunk kernel: d_state {N} (takes a multiple "
                         f"of {STATE_MULTIPLE})")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_chunk kernel: chunk {chunk} must be in "
                         f"1..{MAX_CHUNK} and divide S = {S}")
    if B > GRID_LIMIT or H > GRID_LIMIT:
        raise ValueError(f"ssd_chunk kernel: shape {tuple(xdt.shape)} is "
                         "outside the launch grid")


def _rows_of_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy where its rows cannot be copied 16 bytes
    at a time (the kernel stages x with 16-byte ``cp.async``)."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
            s % 4 == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def plan(B: int, S: int, H: int, P: int, N: int, chunk: int,
         device: torch.device) -> dict:
    """How the kernel cuts a call of this shape on the CUDA ``device``:
    heads per block (``heads``, HG), head groups, blocks per chunk along
    d_state (``slices``), state columns per block and the block count."""
    out = (ctypes.c_int * 4)()
    code = build.entry("repro_ssd_chunk_plan")(
        B, S, H, P, N, chunk, device.index, ctypes.addressof(out))
    build.check(code, "ssd_chunk_kernel plan")
    heads, groups, slices, columns = out
    return {"heads": heads, "groups": groups, "slices": slices,
            "state_columns": columns,
            "blocks": (S // chunk) * groups * slices * B}


@functools.lru_cache(maxsize=256)
def _bwd_plan(B: int, S: int, H: int, P: int, N: int, chunk: int,
              device_index: int) -> tuple:
    out = (ctypes.c_int * 4)()
    code = build.entry("repro_ssd_chunk_bwd_plan")(
        B, S, H, P, N, chunk, device_index, ctypes.addressof(out))
    build.check(code, "ssd_chunk_bwd_kernel plan")
    return tuple(out)


def bwd_plan(B: int, S: int, H: int, P: int, N: int, chunk: int,
             device: torch.device) -> dict:
    """How the backward kernel cuts a call of this shape on the CUDA
    ``device``: heads per block (``heads``, HG), head groups (the
    workspace holds one partial of dB and dC per group), blocks per chunk
    along d_state (``slices``), state columns per block and the block
    count."""
    heads, groups, slices, columns = _bwd_plan(B, S, H, P, N, chunk,
                                               device.index)
    return {"heads": heads, "groups": groups, "slices": slices,
            "state_columns": columns,
            "blocks": (S // chunk) * groups * slices * B}


def ssd_chunk(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor, chunk: int):
    """Launch the kernel over every chunk: xdt ``(B, S, H, P)`` (x scaled
    by dt), a ``(B, S, H)`` (dt * A), Bm and Cm ``(B, S, N)``, f32, any
    strides.  Returns y_intra ``(B, S, H, P)``, state ``(B, nc, H, P, N)``,
    decay ``(B, nc, H)`` and cum ``(B, S, H)``, contiguous f32.  Launches
    on the current stream without synchronizing; raises on anything the
    kernel does not take and when the launch is refused.  There is no
    fallback."""
    _check(xdt, a, Bm, Cm, chunk)
    xdt = _rows_of_16_bytes(xdt)
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    nc = S // chunk
    out = dict(dtype=torch.float32, device=xdt.device)
    y = torch.empty((B, S, H, P), **out)
    state = torch.empty((B, nc, H, P, N), **out)
    decay = torch.empty((B, nc, H), **out)
    cum = torch.empty((B, S, H), **out)
    strides = (ctypes.c_longlong * 13)(*(
        s for t in (xdt, a, Bm, Cm) for s in t.stride()))
    stream = build.current_stream(xdt.device.index)
    code = build.entry("repro_ssd_chunk")(
        xdt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        y.data_ptr(), state.data_ptr(), decay.data_ptr(), cum.data_ptr(),
        ctypes.addressof(strides), B, S, H, P, N, chunk, xdt.device.index,
        stream)
    build.check(code, "ssd_chunk_kernel")
    launches["ssd_chunk_kernel"] += 1
    return y, state, decay, cum


def ssd_chunk_bwd(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, gy: Optional[torch.Tensor],
                  gstate: Optional[torch.Tensor],
                  gcum: Optional[torch.Tensor], chunk: int):
    """The backward of :func:`ssd_chunk`: ``ssd_chunk_bwd_kernel`` (CUDA
    C++, ``csrc/ssd_chunk_bwd.cu``) over every (chunk, group of heads,
    batch), which writes each group's partials of dB and dC into a
    workspace ``(2, B, S, groups, N)`` sized from :func:`bwd_plan`, then
    its reduce pass, which sums the groups in order.

    Takes the forward's inputs (f32, any strides: x is copied where its
    rows are not 16-byte aligned, B and C where their last stride is not 1)
    and the upstream
    gradients of y_intra ``gy (B, S, H, P)``, of the states ``gstate (B,
    nc, H, P, N)`` and of cum ``gcum (B, S, H)``, any of them None (zero);
    decay has no gradient path.  Returns dxdt ``(B, S, H, P)``, da ``(B,
    S, H)``, dB and dC ``(B, S, N)``, contiguous f32.  Recomputes cum, L
    and C B^T from the inputs.  Launches on the current stream without
    synchronizing; raises on anything the kernel does not take and when
    the launch is refused.  There is no fallback: the plain version is
    :func:`repro_torch.kernels.ref.ssd_chunks_bwd`."""
    _check(xdt, a, Bm, Cm, chunk)
    xdt = _rows_of_16_bytes(xdt)
    Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (Bm, Cm))
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    nc = S // chunk
    want = {"gy": (B, S, H, P), "gstate": (B, nc, H, P, N),
            "gcum": (B, S, H)}
    ups = {"gy": gy, "gstate": gstate, "gcum": gcum}
    for name, t in ups.items():
        if t is None:
            continue
        _check_tensors("ssd_chunk_bwd kernel", xdt, ((name, t),))
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_chunk_bwd kernel: {name} must be "
                             f"{want[name]}, got {tuple(t.shape)}")
        ups[name] = _rows_of_16_bytes(t.contiguous())
    out = dict(dtype=torch.float32, device=xdt.device)
    dx = torch.empty((B, S, H, P), **out)
    da = torch.empty((B, S, H), **out)
    dB = torch.empty((B, S, N), **out)
    dC = torch.empty((B, S, N), **out)
    groups = _bwd_plan(B, S, H, P, N, chunk, xdt.device.index)[1]
    work = torch.empty((2, B, S, groups, N), **out)
    strides = (ctypes.c_longlong * 13)(*(
        s for t in (xdt, a, Bm, Cm) for s in t.stride()))
    stream = build.current_stream(xdt.device.index)
    code = build.entry("repro_ssd_chunk_bwd")(
        xdt.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        *(None if t is None else t.data_ptr() for t in ups.values()),
        dx.data_ptr(), da.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        work.data_ptr(), ctypes.addressof(strides), B, S, H, P, N, chunk,
        xdt.device.index, stream)
    build.check(code, "ssd_chunk_bwd_kernel")
    launches["ssd_chunk_bwd_kernel"] += 1
    return dx, da, dB, dC
