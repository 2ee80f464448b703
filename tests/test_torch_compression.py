"""The port's cut codecs (``repro_torch.core.compression``) against the
JAX package's ``repro.core.compression``.

- ``topk_sparsify`` and ``int8_quantize`` give the JAX package's payloads
  exactly, f32 and bf16: top-k keeps exactly k per vector on magnitude
  ties (the stable double argsort), int8 clamps its codes to [0, 255]
  and encodes non-finite inputs as 0.0.
- ``compress_with_feedback`` follows the JAX recursion exactly over three
  steps, residuals included; a stale residual restarts from zero.
- ``payload_bytes`` equals ``wire_bytes`` (and the JAX package's
  ``payload_bytes``) on f32 and bf16 payloads.
- Straight-through gradients equal ``jax.grad`` of the same objective.
- The monolithic path with a codec: the cut layer (codec, then merge)
  bit for bit on one stack; reduced smollm-360m's ``forward`` within
  1e-5 of the JAX package's under top-k and 2e-3 under int8 (one code
  flip, see ``FORWARD_TOL``), and ``train`` (2 steps of AdamW, top-k)
  within 1e-4 in losses and params, from the JAX package's init.

Inputs from numpy with a seed; params carried across by ``interop``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core import compression as jax_comp
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.models import backbone as jax_backbone
from repro.train.loop import train as jax_train
from repro_torch.configs.base import get_arch
from repro_torch.core import compression as comp
from repro_torch.core import costs
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import backbone
from repro_torch.train.loop import train

FRACTIONS = (0.25, 0.1, 1.0)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _both(a: np.ndarray, dtype=torch.float32):
    """The same values as a tensor and a JAX array, in ``dtype``."""
    t = torch.from_numpy(a).to(dtype)
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16
                              else jnp.float32)
    return t, j


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(to_numpy(got),
                                  np.asarray(want.astype(jnp.float32)))


def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    wide = rng.standard_normal((3, 5, 40)).astype(np.float32)
    wide[0] *= 1e4
    wide[1] *= 1e-6
    ties = np.sign(rng.standard_normal((4, 16))).astype(np.float32)
    ties[1] = 0.5  # every magnitude equal, every sign equal
    return {"normal": rng.standard_normal((2, 7, 24)).astype(np.float32),
            "wide": wide, "ties": ties}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fraction", FRACTIONS)
def test_topk_matches_jax(dtype, fraction):
    """The kept entries, their values and the count per vector are the JAX
    package's, ties included (exactly k survive, lowest index first)."""
    for name, a in _inputs().items():
        x, jx = _both(a, dtype)
        got = comp.topk_sparsify(x, fraction)
        assert got.dtype == dtype
        _equal(got, jax_comp.topk_sparsify(jx, fraction))
        k = comp.topk_count(a.shape[-1], fraction)
        if name == "ties":
            assert ((got != 0).sum(-1) == k).all()
            # a stable rank keeps the first k of equal magnitudes
            assert (got[1, :k] != 0).all() and (got[1, k:] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_int8_matches_jax(dtype):
    """Dequantized values equal the JAX package's bit for bit, with the
    clamp and the non-finite guard."""
    cases = dict(_inputs(1))
    bad = np.random.default_rng(2).standard_normal((3, 12)).astype(
        np.float32)
    bad[0, 3], bad[1, 0], bad[2, 5] = np.inf, -np.inf, np.nan
    bad[2, 0] = np.float32(3e38)
    cases["nonfinite"] = bad
    cases["constant"] = np.full((2, 9), 1.5, np.float32)
    for a in cases.values():
        x, jx = _both(a, dtype)
        got = comp.int8_quantize(x)
        assert got.dtype == dtype and torch.isfinite(got).all()
        _equal(got, jax_comp.int8_quantize(jx))
    # the non-finite entries encode as 0.0 (their vector's zero point
    # dequantizes them near zero, never to inf or nan)
    got = comp.int8_quantize(torch.from_numpy(cases["nonfinite"]))
    assert float(got[0, 3].abs()) < 1.0 and float(got[1, 0].abs()) < 1.0


@pytest.mark.parametrize("scheme", comp.SCHEMES)
def test_error_feedback_matches_jax(scheme):
    """Three steps of the error-feedback recursion from a zero residual:
    payloads and residuals equal the JAX package's; a residual of another
    shape is dropped."""
    rng = np.random.default_rng(3)
    res, jres = None, None
    for _ in range(3):
        x, jx = _both(rng.standard_normal((6, 32)).astype(np.float32))
        out, res = comp.compress_with_feedback(x, res, scheme, 0.25)
        jout, jres = jax_comp.compress_with_feedback(jx, jres, scheme, 0.25)
        _equal(out, jout)
        _equal(res, jres)
    x = torch.ones((3, 32))
    out, _ = comp.compress_with_feedback(x, res, scheme, 0.25)
    assert torch.equal(out, comp.apply_compression(x, scheme, 0.25))
    assert comp.compress_with_feedback(x, res, None) == (x, res)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("scheme", [None, *comp.SCHEMES])
def test_payload_bytes_equals_wire_bytes(scheme, dtype):
    """The Ledger's audit: the bytes a payload ships are the analytic claim
    of ``wire_bytes`` (and of ``costs.wire_bytes``) and the JAX package's
    ``payload_bytes``; bf16 values are 2 bytes."""
    a = np.random.default_rng(4).standard_normal((4, 5, 960)).astype(
        np.float32)
    x, jx = _both(a, dtype)
    payload = comp.apply_compression(x, scheme, 0.25)
    jpayload = jax_comp.apply_compression(jx, scheme, 0.25)
    item = x.element_size()
    want = comp.wire_bytes(x.shape, item, scheme, 0.25)
    assert comp.payload_bytes(payload, scheme, 0.25) == want
    assert want == jax_comp.payload_bytes(jpayload, scheme, 0.25)
    assert want == jax_comp.wire_bytes(jx.shape, item, scheme, 0.25)
    assert want == costs.wire_bytes(x.shape, item, scheme, 0.25)
    with pytest.raises(ValueError):
        comp.payload_bytes(payload, "gzip")


@pytest.mark.parametrize("scheme", comp.SCHEMES)
def test_straight_through_gradients_match_jax(scheme):
    """The gradient of ``sum(w * C(x))`` w.r.t. x is w: identity through
    the codec, as ``jax.grad`` gives it; the forward is the payload."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((3, 16)).astype(np.float32)
    x = torch.from_numpy(a).requires_grad_(True)
    y = comp.apply_compression(x, scheme, 0.25)
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), x)
    jg = jax.grad(lambda v: jnp.sum(
        jax_comp.apply_compression(v, scheme, 0.25) * w))(jnp.asarray(a))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(g.numpy(), w)
    _equal(y.detach(), jax_comp.apply_compression(jnp.asarray(a), scheme,
                                                  0.25))
    with pytest.raises(ValueError, match="unknown compression scheme"):
        comp.apply_compression(x, "gzip")


def _codec_configs(scheme: str):
    jcfg, cfg = jax_get_arch("smollm-360m").reduced(), \
        get_arch("smollm-360m").reduced()
    return (jcfg.with_vertical(dataclasses.replace(
                jcfg.vertical, compression=scheme)),
            cfg.with_vertical(dataclasses.replace(
                cfg.vertical, compression=scheme)))


@pytest.fixture(scope="module")
def init():
    """The JAX package's seeded init of reduced smollm-360m (the codec does
    not change the tree), and the same numbers as tensors."""
    jcfg = jax_get_arch("smollm-360m").reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


# an int8 code is 1/255 of its vector's range: ~1e-7 differences between
# the packages' tower outputs flip single codes, each moving one cut entry
# by a level (~1e-2 here) and the reduced logits by up to ~1e-3; top-k
# flips need a near tie at the k-th magnitude.  The cut layer itself is
# held bit for bit on one stack below
FORWARD_TOL = {"topk": TOL, "int8": dict(rtol=0, atol=2e-3)}


@pytest.mark.parametrize("scheme", comp.SCHEMES)
def test_monolithic_forward_with_codec_matches_jax(scheme, init):
    """``backbone.forward`` runs the codec on the towers' cut stack before
    the merge, as the JAX package's does: the cut layer bit for bit on one
    stack, the logits within ``FORWARD_TOL``."""
    from repro.core import merge as jax_merge

    jcfg, cfg = _codec_configs(scheme)
    jparams, params = init
    stack = np.random.default_rng(7).standard_normal((2, 3, 5, 64)).astype(
        np.float32)
    got = backbone._merge_cuts(list(torch.from_numpy(stack)), cfg)
    want = jax_merge.merge_stacked(jax_comp.apply_compression(
        jnp.asarray(stack), scheme, 0.25), jcfg.vertical.merge)
    _equal(got, want)
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, _ = jax_backbone.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                   jcfg)
    got, _ = backbone.forward(params, {"tokens": torch.from_numpy(tokens)},
                              cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **FORWARD_TOL[scheme])
    plain, _ = backbone.forward(params, {"tokens": torch.from_numpy(tokens)},
                                cfg.with_vertical(dataclasses.replace(
                                    cfg.vertical, compression=None)))
    assert not torch.equal(got, plain)  # the codec is on the path


def test_monolithic_train_with_codec_matches_jax():
    """``train`` of a top-k config: two AdamW steps from the JAX package's
    init, losses and final params at 1e-4."""
    jcfg, cfg = _codec_configs("topk")
    kw = dict(steps=2, print_fn=lambda *a: None)
    jparams, jmetrics = jax_train(
        jcfg, JaxLMBatchLoader(jcfg, 4, 16, seed=0), **kw)
    init = jax_backbone.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, init),
                               "cpu")
    got, metrics = train(cfg, LMBatchLoader(cfg, 4, 16, seed=0),
                         device="cpu", params=params, **kw)
    np.testing.assert_allclose(metrics.losses, jmetrics.losses, **RUN_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(got)),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), **RUN_TOL)
