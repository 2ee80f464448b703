"""Build and load the port's CUDA C++ kernels.

The sources under ``csrc/`` (``*.cu`` with a plain C interface) are
compiled by ``nvcc`` for ``sm_90a`` into one shared library at first use,
and loaded with ``ctypes``.  The library lives in ``build/kernels/`` at the
root of the checkout and is named by a hash of the sources and the flags:
an edit to any source builds a new library, an unchanged tree loads the
one already built.  Each source compiles in its own ``nvcc`` process, all
started together, and the objects are then linked.  ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory and spills per kernel) is
kept beside the library as ``<name>.log``.

``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin``, then in
the toolkit's default prefix ``/usr/local/cuda/bin``; without one, the
first kernel launch raises.  Nothing here runs when the module is
imported: the CPU, which has no ``nvcc``, imports every module.

Every pointer and the stream cross the C interface as ``ctypes.c_void_p``
(a plain Python int would be cut to 32 bits).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
TOOLKIT_PREFIX = Path("/usr/local/cuda")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: the C entry points and their ctypes signatures: (argtypes, restype)
SIGNATURES = {
    # q, k, v, o, lse, strides (12 x int64), dtype, B, H, Hkv, S, D,
    # causal, device, stream
    "repro_flash_attention": ([_P] * 6 + [_I] * 8 + [_P], _I),
    # q, k, v, o, dout, lse, delta, part, dq, dk, dv, strides (24 x
    # int64), dtype, B, H, Hkv, S, D, causal, device, stream
    "repro_flash_attention_bwd": ([_P] * 12 + [_I] * 8 + [_P], _I),
    # B, H, Hkv, S, D, dtype, device, out (8 x int)
    "repro_flash_attention_bwd_plan": ([_I] * 7 + [_P], _I),
    # x, a, bm, cm, y, state, decay, cum, strides (13 x int64), B, S, H, P,
    # N, Q, device, stream
    "repro_ssd_chunk": ([_P] * 9 + [_I] * 7 + [_P], _I),
    # x, a, bm, cm, gy, gstate, gcum, dx, da, dbm, dcm, work, strides (13 x
    # int64), B, S, H, P, N, Q, device, stream
    "repro_ssd_chunk_bwd": ([_P] * 13 + [_I] * 7 + [_P], _I),
    # B, S, H, P, N, Q, device, out (4 x int)
    "repro_ssd_chunk_plan": ([_I] * 7 + [_P], _I),
    "repro_ssd_chunk_bwd_plan": ([_I] * 7 + [_P], _I),
    # x, live, out, n (= B * D), K, strategy, dtype, device, stream
    "repro_merge_reduce": ([_P] * 3 + [ctypes.c_longlong] + [_I] * 4 + [_P],
                           _I),
    # g, live, x, out, dx, n (= B * D), K, strategy, dtype, device, stream
    "repro_merge_reduce_bwd": ([_P] * 5 + [ctypes.c_longlong] + [_I] * 4
                               + [_P], _I),
    # x, live, out, B, D, K, dtype, device, stream
    "repro_merge_concat": ([_P] * 3 + [_I] * 5 + [_P], _I),
    # live, g, dx, B, D, K, dtype, device, stream
    "repro_merge_concat_bwd": ([_P] * 3 + [_I] * 5 + [_P], _I),
    "repro_cuda_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None
_entries: dict = {}


def sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir()
                  if p.suffix in (".cu", ".cuh", ".h"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return BUILD_DIR / f"libreprokernels-{digest.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    prefixes = [Path(os.environ["CUDA_HOME"])] if os.environ.get(
        "CUDA_HOME") else []
    for prefix in prefixes + [TOOLKIT_PREFIX]:
        nvcc = prefix / "bin" / "nvcc"
        if nvcc.is_file() and os.access(nvcc, os.X_OK):
            return str(nvcc)
    raise RuntimeError(
        "repro_torch kernels: nvcc was not found on PATH, under "
        "$CUDA_HOME/bin or in /usr/local/cuda/bin — the CUDA kernels are "
        "compiled from src/repro_torch/kernels/csrc at first use and need "
        "the CUDA toolkit")


def _run_all(commands: list[list[str]]) -> list[str]:
    """Run the commands in parallel; return their combined output, or
    raise with the first failure's output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(commands, procs, outputs):
        if proc.returncode:
            raise RuntimeError(
                f"repro_torch kernels: nvcc failed ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{out}")
    return outputs


def build() -> Path:
    """Compile the sources into the library unless it exists; returns its
    path.  Builds in a scratch directory and moves the result into place,
    so concurrent builders never load a half-written file."""
    target = library_path()
    if target.exists():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    units = [p for p in sources() if p.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / (p.stem + ".o") for p in units]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                         for src, obj in zip(units, objects)])
        lib = Path(tmp) / target.name
        _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-shared", "-o", str(lib), *map(str, objects)]])
        target.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed; signatures set.  The
    lock is taken only until the library is loaded."""
    global _library
    lib = _library
    if lib is None:
        with _lock:
            if _library is None:
                lib = ctypes.CDLL(str(build()))
                for name, (argtypes, restype) in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes, fn.restype = argtypes, restype
                _library = lib
            lib = _library
    return lib


def entry(name: str):
    """The library's C entry point ``name``, resolved once."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(library(), name)
    return fn


def current_stream(device: int) -> int:
    """PyTorch's current stream on CUDA device ``device`` (an index), as
    the raw ``cudaStream_t`` the C entry points take.  The raw query is
    what PyTorch's own Triton launcher reads; ``torch.cuda.current_stream``
    builds a ``Stream`` object around it first, host time that a small
    kernel such as the merge's would pay on every call."""
    return torch._C._cuda_getCurrentRawStream(device)


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code:
        message = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: launch failed with CUDA error {code} "
                           f"({message})")
