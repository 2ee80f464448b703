"""Compact Bilinear Pooling merge (paper §3: "one can readily employ other
encoding methods like Compact Bilinear Pooling ... instead of the pooling
mechanisms for a more robust representation learning").

CBP (Gao et al., CVPR 2016) approximates the outer-product (bilinear)
interaction of two feature vectors by convolving their Count-Sketch
projections — computed in O(D + d log d) via FFT:

    psi(x): count-sketch of x into d dims (random signs s, random buckets h)
    cbp(x, y) = ifft( fft(psi(x)) * fft(psi(y)) )

For K > 2 clients the clients fold in one after another (the
frequency-domain product of all K sketches), which approximates the
order-K polynomial interaction.  A dropped client is imputed with the
mean sketch of the live ones (see :func:`merge_cbp`).

The JAX package's module, in PyTorch: plain ``torch`` on both devices,
as it is plain ``jnp`` there (no kernel).  The sketch's random signs and
buckets come from a ``torch.Generator``; the JAX package's ``jax.random``
draws cannot be reproduced, so a comparison carries its ``signs`` and
``buckets`` across.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class CountSketch(NamedTuple):
    """Fixed random sketch parameters (shared by all parties, public)."""

    signs: torch.Tensor  # (K, D) f32 in {-1, +1}
    buckets: torch.Tensor  # (K, D) int64 in [0, d_out)
    d_out: int

    @staticmethod
    def create(generator: torch.Generator, num_clients: int, d_in: int,
               d_out: int) -> "CountSketch":
        """Signs and buckets drawn from ``generator``, on its device."""
        dev = generator.device
        signs = torch.randint(0, 2, (num_clients, d_in), generator=generator,
                              device=dev).float() * 2.0 - 1.0
        buckets = torch.randint(0, d_out, (num_clients, d_in),
                                generator=generator, device=dev)
        return CountSketch(signs, buckets, d_out)


def count_sketch(x: torch.Tensor, signs: torch.Tensor,
                 buckets: torch.Tensor, d_out: int) -> torch.Tensor:
    """x ``(..., D)`` -> ``(..., d_out)``; psi preserves inner products in
    expectation: E[<psi(x), psi(y)>] = <x, y>.  A 1-D ``x`` accumulates
    every entry into its bucket (``index_add_``: repeated buckets add up,
    as the reference's ``.at[].add`` does); a batched one is the one-hot
    product of :func:`_batched_scatter`."""
    signed = x * signs
    if x.ndim != 1:
        return _batched_scatter(signed, buckets, d_out)
    out = torch.zeros((d_out,), dtype=x.dtype, device=x.device)
    return out.index_add_(0, buckets.long(), signed.to(x.dtype))


def _batched_scatter(signed: torch.Tensor, buckets: torch.Tensor,
                     d_out: int) -> torch.Tensor:
    """signed ``(..., D)``; buckets ``(D,)`` -> ``(..., d_out)`` through a
    one-hot product (scatter-free)."""
    onehot = F.one_hot(buckets.long(), d_out).to(signed.dtype)  # (D, d_out)
    return signed @ onehot


def merge_cbp(cuts: torch.Tensor, sketch: CountSketch, *,
              live_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Compact bilinear merge of K clients' cuts ``(K, ..., D)`` ->
    ``(..., d_out)`` real features, in the cuts' dtype.  A dropped client
    contributes the mean sketch of the live ones."""
    K = cuts.shape[0]
    if live_mask is None:
        live_mask = torch.ones((K,), dtype=cuts.dtype, device=cuts.device)
    sketches = torch.stack([
        _batched_scatter(cuts[k] * sketch.signs[k], sketch.buckets[k],
                         sketch.d_out)
        for k in range(K)])  # (K, ..., d_out)

    # dropped client -> mean sketch of the live ones (keeps the product's
    # scale stable; the mul-style neutral element 1 is wrong in sketch
    # space)
    lv = live_mask.reshape((K,) + (1,) * (sketches.ndim - 1))
    n_live = torch.clamp_min(torch.sum(live_mask), 1.0)
    mean_sketch = torch.sum(sketches * lv, dim=0) / n_live.to(cuts.dtype)
    sketches = torch.where(lv > 0, sketches, mean_sketch[None])

    freq = torch.fft.rfft(sketches.float(), dim=-1)
    prod = freq[0]
    for k in range(1, K):
        prod = prod * freq[k]
    out = torch.fft.irfft(prod, n=sketch.d_out, dim=-1)
    # signed sqrt + l2 normalization (standard CBP post-processing)
    out = torch.sign(out) * torch.sqrt(torch.abs(out) + 1e-8)
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return (out / torch.clamp_min(norm, 1e-6)).to(cuts.dtype)


def sketch_inner_product_preserved(generator: torch.Generator, d_in: int = 64,
                                   d_out: int = 512, n: int = 256) -> float:
    """Diagnostic: mean relative error of <psi(x), psi(y)> vs <x, y>."""
    dev = generator.device
    xs = torch.randn((n, d_in), generator=generator, device=dev)
    ys = torch.randn((n, d_in), generator=generator, device=dev)
    sk = CountSketch.create(generator, 1, d_in, d_out)
    px = _batched_scatter(xs * sk.signs[0], sk.buckets[0], d_out)
    py = _batched_scatter(ys * sk.signs[0], sk.buckets[0], d_out)
    true = torch.sum(xs * ys, -1)
    est = torch.sum(px * py, -1)
    return float(torch.mean(torch.abs(est - true))
                 / torch.mean(torch.abs(true)))
