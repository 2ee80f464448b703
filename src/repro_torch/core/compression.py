"""Cut compression — the port's copy of the one contract it needs so far:
the wire size of a cut or jacobian payload under a codec, which the
engine's step plans price.

The codecs themselves (top-k STC, int8, error feedback) are not ported
yet; every layer that would run them refuses them by name
(``core.protocol._reject_unported``).
"""
from __future__ import annotations

SCHEMES = ("topk", "int8")


def topk_count(last_dim: int, fraction: float) -> int:
    """Entries kept per feature vector: the k of top-k."""
    return max(1, int(round(last_dim * fraction)))


def wire_bytes(shape, dtype_bytes: int, scheme: str | None,
               topk_fraction: float = 0.25) -> int:
    """Bytes on the wire for one cut/jacobian payload under a scheme.

    topk ships an STC-style sparse frame per vector: a D-bit coordinate
    bitmap plus the k kept values — at fraction 0.25 and f32 values that is
    ``0.25*4 + 1/8`` ≈ 0.28x the raw f32 payload; int8 ships one code per
    element plus an 8-byte scale/zero-point per vector."""
    n = 1
    for s in shape:
        n *= s
    if scheme is None:
        return n * dtype_bytes
    D = shape[-1]
    vecs = n // D
    if scheme == "topk":
        k = topk_count(D, topk_fraction)
        return vecs * ((D + 7) // 8 + k * dtype_bytes)
    if scheme == "int8":
        return n + vecs * 8  # int8 codes + scale/zero-point per vector
    raise ValueError(scheme)
