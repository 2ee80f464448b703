"""The Compact Bilinear Pooling merge (``repro_torch.core.bilinear``)
against the JAX package's ``repro.core.bilinear``.

The sketch's signs and buckets are drawn by the JAX package
(``CountSketch.create``) and carried across: ``jax.random`` draws cannot
be reproduced from a ``torch.Generator``.  ``count_sketch`` of a 1-D
vector whose buckets repeat (they must add up, not overwrite) and of a
batch; ``merge_cbp`` at K = 2, 3 and 4 clients, with every client live
and with one dropped (the mean sketch of the live ones stands in), in
f32 and bf16; the port's own ``CountSketch.create`` and its diagnostic.

Inputs from ``numpy.random.default_rng`` seeds.  Tolerances: a sketch
1e-5 (sums of a few signed inputs); ``merge_cbp``'s output (unit L2
norm, entries ~ d_out^-1/2) within 1e-5 of its largest entry in f32 and
within 2 bf16 ulps of 1 in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bilinear as jax_bilinear
from repro_torch.core import bilinear

SKETCH_TOL = dict(rtol=1e-5, atol=1e-5)
D_IN, D_OUT, ROWS = 48, 64, 6


def _sketch(k, d_in=D_IN, d_out=D_OUT, seed=0):
    jsk = jax_bilinear.CountSketch.create(jax.random.PRNGKey(seed), k, d_in,
                                          d_out)
    sk = bilinear.CountSketch(torch.from_numpy(np.array(jsk.signs)),
                              torch.from_numpy(np.array(jsk.buckets)),
                              d_out)
    return jsk, sk


def _cuts(k, seed, rows=ROWS, d_in=D_IN):
    return np.random.default_rng(seed).standard_normal(
        (k, rows, d_in)).astype(np.float32)


def test_count_sketch_1d_accumulates_repeated_buckets():
    """A 1-D vector: every entry lands in its bucket, and entries that
    share a bucket add up (``index_add_``; a plain indexed ``+=`` would
    keep one write per bucket)."""
    x = np.random.default_rng(1).standard_normal(12).astype(np.float32)
    signs = np.where(np.random.default_rng(2).random(12) < 0.5, -1.0,
                     1.0).astype(np.float32)
    buckets = np.array([0, 3, 3, 1, 0, 3, 5, 5, 2, 0, 4, 3])
    want = jax_bilinear.count_sketch(jnp.asarray(x), jnp.asarray(signs),
                                     jnp.asarray(buckets), 7)
    got = bilinear.count_sketch(torch.from_numpy(x), torch.from_numpy(signs),
                                torch.from_numpy(buckets), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SKETCH_TOL)
    np.testing.assert_allclose(got.numpy()[3], (x * signs)[[1, 2, 5, 11]].sum(),
                               **SKETCH_TOL)
    assert got.numpy()[6] == 0.0


def test_count_sketch_batched_matches_jax():
    """A batch ``(2, 3, D)`` goes through the one-hot product; its sketch
    is linear, as the JAX package's test of its own holds it."""
    jsk, sk = _sketch(1)
    x = _cuts(2, 3)[:, :3]  # (2, 3, D)
    want = jax_bilinear.count_sketch(jnp.asarray(x), jsk.signs[0],
                                     jsk.buckets[0], D_OUT)
    got = bilinear.count_sketch(torch.from_numpy(x), sk.signs[0],
                                sk.buckets[0], D_OUT)
    assert got.shape == (2, 3, D_OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SKETCH_TOL)
    y = torch.from_numpy(_cuts(2, 4)[:, :3])
    both = bilinear._batched_scatter((torch.from_numpy(x) + y) * sk.signs[0],
                                     sk.buckets[0], D_OUT)
    np.testing.assert_allclose(
        both.numpy(), (got + bilinear._batched_scatter(
            y * sk.signs[0], sk.buckets[0], D_OUT)).numpy(), **SKETCH_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop", [False, True], ids=["live", "drop"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_merge_cbp_matches_jax(k, drop, dtype):
    """K clients, all live or client 1 dropped, in ``dtype``: the output
    dtype, shape and unit norm, and the values against the JAX
    package's."""
    jsk, sk = _sketch(k, seed=k)
    cuts = _cuts(k, seed=10 + k)
    live = np.ones(k, np.float32)
    if drop:
        live[1] = 0.0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jcuts = jnp.asarray(cuts).astype(jdt)
    tcuts = torch.from_numpy(cuts).to(tdt)
    want = jax_bilinear.merge_cbp(jcuts, jsk,
                                  live_mask=jnp.asarray(live) if drop
                                  else None)
    got = bilinear.merge_cbp(tcuts, sk, live_mask=torch.from_numpy(live)
                             if drop else None)
    assert got.dtype == tdt and got.shape == (ROWS, D_OUT)
    want = np.asarray(want.astype(jnp.float32))
    out = got.float().numpy()
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), np.ones(ROWS),
                               rtol=1e-2 if dtype == "bfloat16" else 1e-5)
    if dtype == "bfloat16":
        np.testing.assert_allclose(out, want, rtol=0, atol=2 * 2.0 ** -8)
        return
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if drop:  # the dropped client's cut is ignored
        cuts2 = cuts.copy()
        cuts2[1] = 7.0
        again = bilinear.merge_cbp(torch.from_numpy(cuts2), sk,
                                   live_mask=torch.from_numpy(live))
        np.testing.assert_allclose(again.numpy(), out, rtol=1e-6, atol=1e-6)


def test_create_and_diagnostic():
    """The port's own sketch from a ``torch.Generator``: signs in {-1, +1},
    buckets in [0, d_out), the same draws from the same seed; the inner
    product is preserved in expectation (the JAX package's bound on its
    diagnostic)."""
    a = bilinear.CountSketch.create(torch.Generator().manual_seed(0), 3, 16,
                                    64)
    b = bilinear.CountSketch.create(torch.Generator().manual_seed(0), 3, 16,
                                    64)
    assert a.signs.shape == a.buckets.shape == (3, 16) and a.d_out == 64
    assert set(a.signs.unique().tolist()) == {-1.0, 1.0}
    assert a.signs.dtype == torch.float32
    assert int(a.buckets.min()) >= 0 and int(a.buckets.max()) < 64
    assert torch.equal(a.signs, b.signs) and torch.equal(a.buckets, b.buckets)
    err = bilinear.sketch_inner_product_preserved(
        torch.Generator().manual_seed(0), d_in=64, d_out=1024)
    assert err < 0.6, f"sketch too lossy: {err}"
    from repro_torch import core

    assert core.bilinear is bilinear
