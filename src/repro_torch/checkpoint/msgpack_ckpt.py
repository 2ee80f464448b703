"""Msgpack pytree checkpoints, in the JAX package's on-disk format.

Arrays are serialized as (dtype, shape, raw bytes) maps — ``{"__nd__":
true, "dtype": "<f4", "shape": [...], "data": <bin>}``, bfloat16 as
``{"__nd__": true, "__bf16__": true, "shape": [...], "data": <bin of the
uint16 bits>}`` — and the tree as nested maps, with lists and tuples as
``{"__list__": [...], "__tuple__": bool}`` and None as ``{"__none__":
true}``.  The payload ``{"tree": ..., "step": n}`` is msgpack with the
binary type, written to ``path + ".tmp"`` and moved into place with
``os.replace``, so a file written by either package loads in the other.

The port carries its own msgpack encoder and decoder (:func:`packb`,
:func:`unpackb`) for the subset the format uses: maps with string keys,
arrays, strings, binaries, integers, booleans and nil.  The encoder
picks the smallest encoding of each value, as the ``msgpack`` package
does, so the two write the same bytes.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

_ARRAY_KEY = "__nd__"
_BF16_KEY = "__bf16__"


# ---------------------------------------------------------------------------
# msgpack, the subset the format uses
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: list) -> None:
    if -32 <= n < 128:
        out.append(struct.pack("b", n) if n < 0 else bytes((n,)))
    elif n >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < top:
                out.append(bytes((code,)) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack's uint64")
    else:
        for code, fmt, bottom in ((0xd0, ">b", -(1 << 7)),
                                  (0xd1, ">h", -(1 << 15)),
                                  (0xd2, ">i", -(1 << 31)),
                                  (0xd3, ">q", -(1 << 63))):
            if n >= bottom:
                out.append(bytes((code,)) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack's int64")


def _pack_header(n: int, fix: Optional[int], fix_max: int, codes: tuple,
                 out: list) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes``; an 8-bit code of None has no such form)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(bytes((code,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} does not fit msgpack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_header(len(data), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj)
        # a flat byte view (a view with a zero in its shape cannot cast)
        data = data.cast("B") if data.nbytes else b""
        _pack_header(len(data), None, 0, (0xc4, 0xc5, 0xc6), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_header(len(obj), 0x90, 16, (None, 0xdc, 0xdd), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_header(len(obj), 0x80, 16, (None, 0xde, 0xdf), out)
        for key, val in obj.items():
            _pack(key, out)
            _pack(val, out)
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def _pack_parts(obj) -> list:
    out: list = []
    _pack(obj, out)
    return out


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the supported types."""
    return b"".join(_pack_parts(obj))


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LENGTH = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H",
           0xc6: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}


def _unpack(r: _Reader):
    code = r.unpack(">B")
    if code < 0x80:
        return code
    if code >= 0xe0:
        return code - 0x100
    if code == 0xc0:
        return None
    if code in (0xc2, 0xc3):
        return code == 0xc3
    if code in _FIXED:
        return r.unpack(_FIXED[code])
    if 0xa0 <= code <= 0xbf or code in (0xd9, 0xda, 0xdb):
        n = code & 0x1f if code <= 0xbf else r.unpack(_LENGTH[code])
        return str(r.take(n), "utf-8")
    if code in (0xc4, 0xc5, 0xc6):
        return r.take(r.unpack(_LENGTH[code])).tobytes()
    if 0x90 <= code <= 0x9f or code in (0xdc, 0xdd):
        n = code & 0x0f if code <= 0x9f else r.unpack(_LENGTH[code])
        return [_unpack(r) for _ in range(n)]
    if 0x80 <= code <= 0x8f or code in (0xde, 0xdf):
        n = code & 0x0f if code <= 0x8f else r.unpack(_LENGTH[code])
        out = {}
        for _ in range(n):
            key = _unpack(r)
            out[key] = _unpack(r)
        return out
    raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")


def unpackb(data):
    """``msgpack.unpackb(data, raw=False, strict_map_key=False)`` for the
    supported types (arrays come back as lists)."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj


# ---------------------------------------------------------------------------
# the checkpoint format
# ---------------------------------------------------------------------------

def _pack_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return {_ARRAY_KEY: True, _BF16_KEY: True, "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().data}
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(x))
        if arr.dtype.name == "bfloat16":  # numpy's ml_dtypes extension
            return {_ARRAY_KEY: True, _BF16_KEY: True,
                    "shape": list(arr.shape), "data": arr.view(np.uint16).data}
    return {_ARRAY_KEY: True, "dtype": arr.dtype.str, "shape": list(arr.shape),
            "data": arr.data}


def _unpack_leaf(d: dict, device: torch.device) -> torch.Tensor:
    shape = tuple(d["shape"])
    if d.get(_BF16_KEY):
        a = np.frombuffer(d["data"], np.int16).reshape(shape).copy()
        return torch.from_numpy(a).view(torch.bfloat16).to(device)
    a = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(shape).copy()
    return torch.from_numpy(a).to(device)


def _encode(tree):
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {"__list__": [_encode(v) for v in tree],
                "__tuple__": isinstance(tree, tuple)}
    if tree is None:
        return {"__none__": True}
    return _pack_leaf(tree)


def _decode(obj, device: torch.device):
    if isinstance(obj, dict):
        if obj.get(_ARRAY_KEY):
            return _unpack_leaf(obj, device)
        if obj.get("__none__"):
            return None
        if "__list__" in obj:
            items = [_decode(v, device) for v in obj["__list__"]]
            return tuple(items) if obj.get("__tuple__") else items
        return {k: _decode(v, device) for k, v in obj.items()}
    return obj


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> None:
    """Write ``tree`` (tensors on any device, numpy arrays, None, nested
    dicts, lists and tuples) and ``step`` to ``path`` atomically."""
    payload = {"tree": _encode(tree)}
    if step is not None:
        payload["step"] = step
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.writelines(_pack_parts(payload))
    os.replace(tmp, path)


def load_checkpoint(path: str, device: DeviceLike = None):
    """Returns (tree, step): every array a tensor of its saved dtype on
    ``device`` — the host when None, where the JAX package leaves numpy
    arrays; a card only when asked for."""
    dev = torch.device("cpu") if device is None else resolve_device(device)
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    return _decode(payload["tree"], dev), payload.get("step")
