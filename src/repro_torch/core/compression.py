"""Cut-layer activation/jacobian compression (beyond the paper).

The paper's §4.4 names STC-style sparsification as a way to cut
cut-layer traffic.  Two codecs, each with straight-through gradients so
they compose with end-to-end training:

* top-k sparsification (STC-flavoured): keep the k largest-|x| entries per
  feature vector, zero the rest — the wire frame is a D-bit coordinate
  bitmap plus the k kept values per vector;
* int8 affine quantization: per-vector scale/zero-point.

:func:`wire_bytes` is the analytic claim, :func:`payload_bytes` the bytes
one payload actually ships; the protocol ``Ledger`` records the second
and tests reconcile it exactly with the first.

On the execution path compression runs at the transport boundary with
**error feedback** (:func:`compress_with_feedback`): the residual each
compression step drops is carried into the next step's payload —
``TowerWorker`` compresses cut uplinks at the source, the ``Executor``
compresses jacobian downlinks symmetrically.  Secure aggregation does not
compose with compression (additive f32 masks do not cancel through
quantized or sparsified values): the compat matrix rejects the pair.

The codecs are the JAX package's arithmetic in the same order, elementwise
and sort work in plain PyTorch (the JAX package runs them in plain ``jnp``
too, outside any Pallas kernel).
"""
from __future__ import annotations

from typing import Optional

import torch

SCHEMES = ("topk", "int8")

# step-0 in-run verification tolerance (train_split): the transport's
# compressed step-0 gradients vs the serial ``protocol_step`` running the
# SAME compression with zero error-feedback residual — the two paths
# compute identical compressed payloads, so this only absorbs float
# accumulation-order noise
STEP0_VERIFY_ATOL = 1e-4

# the JAX package's documented compression-error tolerances: empirical
# max |compressed grad - plain grad| bounds for its reduced verification
# configs.  They bound the accuracy cost of the lossy wire, not the wire
# path's numerics, so they are loose
GRAD_VS_PLAIN_ATOL = {"topk": 1.5, "int8": 0.25}


class _STE(torch.autograd.Function):
    """Straight-through: forward ``y``, backward identity to ``x``.  The
    output is ``y`` itself, bit for bit (``x + (y - x).detach()`` would
    round)."""

    @staticmethod
    def forward(ctx, x, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _ste(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _STE.apply(x, y.detach())


def topk_count(last_dim: int, fraction: float) -> int:
    """Entries kept per feature vector: the k of top-k."""
    return max(1, int(round(last_dim * fraction)))


def topk_sparsify(x: torch.Tensor, fraction: float) -> torch.Tensor:
    """Keep EXACTLY the top-``fraction`` entries by magnitude along the last
    axis, ties broken by ascending index: a stable argsort of -|x| ranks
    equal magnitudes by index (``torch.topk`` does not), so exactly k
    survive and the payload never exceeds the k-per-vector wire contract
    that :func:`wire_bytes` claims and the Ledger audits."""
    k = topk_count(x.shape[-1], fraction)
    mag = x.detach().abs()
    order = torch.argsort(-mag, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    sparse = torch.where(ranks < k, x.detach(), torch.zeros_like(x))
    return _ste(x, sparse)


def int8_quantize(x: torch.Tensor) -> torch.Tensor:
    """Fake-quantize to int8 per vector (affine), straight-through grads.

    Codes are clamped to [0, 255], and non-finite inputs (unrepresentable
    in any affine int8 frame) are encoded as 0.0 rather than poisoning the
    vector's scale.  Rounding is half to even, as ``jnp.round``."""
    x_ = x.detach()
    safe = torch.where(torch.isfinite(x_), x_, torch.zeros_like(x_))
    lo = torch.amin(safe, dim=-1, keepdim=True)
    hi = torch.amax(safe, dim=-1, keepdim=True)
    scale = torch.clamp(hi - lo, min=1e-8) / 255.0
    q = torch.clamp(torch.round((safe - lo) / scale), 0.0, 255.0)
    deq = q * scale + lo
    return _ste(x, deq.to(x.dtype))


def apply_compression(x: torch.Tensor, scheme: Optional[str],
                      topk_fraction: float = 0.25) -> torch.Tensor:
    if scheme is None:
        return x
    if scheme == "topk":
        return topk_sparsify(x, topk_fraction)
    if scheme == "int8":
        return int8_quantize(x)
    raise ValueError(f"unknown compression scheme {scheme!r}")


def compress_with_feedback(x: torch.Tensor, residual: Optional[torch.Tensor],
                           scheme: Optional[str],
                           topk_fraction: float = 0.25):
    """One error-feedback step: compress ``x + residual``; return
    ``(compressed, new_residual)``, the new residual being what this
    encode dropped.  ``residual=None`` (or a stale one whose shape no
    longer matches) starts from zero — which is why step-0 payloads equal
    a plain :func:`apply_compression` and the serial reference can verify
    them."""
    if scheme is None:
        return x, residual
    if residual is not None and residual.shape != x.shape:
        residual = None
    target = x if residual is None else x + residual
    compressed = apply_compression(target, scheme, topk_fraction)
    return compressed, target - compressed


def wire_bytes(shape, dtype_bytes: int, scheme: Optional[str],
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


def payload_bytes(x: torch.Tensor, scheme: Optional[str],
                  topk_fraction: float = 0.25) -> int:
    """Actual wire bytes of ONE compressed payload, read from the payload
    rather than the analytic k-per-vector claim: for topk the stored
    values are the nonzeros (a kept exact 0.0 decodes the same unshipped).
    With the tie rule above this equals :func:`wire_bytes` on any payload
    with nonzero kept values — the equality IS the Ledger's audit, and a
    codec that kept more than k entries shows up as a byte mismatch.

    The nonzero count is read back to the host: one device sync per
    payload on the card."""
    if scheme is None:
        return x.numel() * x.element_size()
    D = x.shape[-1]
    vecs = x.numel() // D
    if scheme == "topk":
        nnz = int(torch.count_nonzero(x))
        return vecs * ((D + 7) // 8) + nnz * x.element_size()
    if scheme == "int8":
        return x.numel() + vecs * 8  # dequantized values cross; codes ship
    raise ValueError(scheme)
