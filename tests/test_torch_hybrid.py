"""The hybrid family (zamba2-7b) against the JAX package: super-blocks of
``shared_attn_every`` Mamba2 layers, each followed by ONE weight-shared
attention block, then the trailing Mamba2 layers.

Here: ``hybrid_layout`` and the init tree (keys, shapes, ``None`` where
a part is empty) at ``every`` 1 and 2 over 5 server layers (5
super-blocks; 2 super-blocks and a tail) and at 1 layer under ``every`` 2
(no super-block, a tail only); ``hybrid_stack_apply`` (64 tokens, two
chunks) and three steps of ``hybrid_stack_decode`` at each, on reduced
zamba2-7b's widths (d_model 256, 4 heads of 64, d_state 16, chunks of
32); the gradients of the stack at ``every`` 2 with a tail.  The whole model is ``tests/test_torch_hybrid_model.py``, its
training ``tests/test_torch_hybrid_train.py`` (a file each, so that each
runs in well under a minute: the JAX package compiles op by op).

Inputs come from ``numpy.random.default_rng`` seeds; params from the JAX
package's seeded init, carried across by ``interop``.  f32.  Tolerances
are ``tests/test_torch_ssd.py``'s: a stack's output and caches 1e-5,
its gradients within 1e-5 of their largest entries.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import backbone as jax_backbone
from repro.models import transformer as jax_tfm
from repro_torch.configs.base import get_arch
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import backbone
from repro_torch.models import transformer as tfm

ARCH = "zamba2-7b"
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SEQ = 64  # two chunks of the reduced config's 32
# (server layers, every): 5 super-blocks; 2 super-blocks + a tail; a tail
LAYOUTS = [(5, 1), (5, 2), (1, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(num_layers=None, every=None, vertical=True):
    jcfg, cfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    if num_layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=num_layers)
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    if every is not None:
        jcfg = dataclasses.replace(jcfg, hybrid=dataclasses.replace(
            jcfg.hybrid, shared_attn_every=every))
        cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
            cfg.hybrid, shared_attn_every=every))
    if not vertical:
        jcfg, cfg = jcfg.with_vertical(None), cfg.with_vertical(None)
    return jcfg, cfg


def _carried(jcfg, seed=0):
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _shapes(tree):
    """(shape, dtype name) per leaf of a JAX or a torch tree; None stays."""
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
        tree)


def _close(got, want, tol):
    got = to_numpy(got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


@pytest.mark.parametrize("n,every", LAYOUTS,
                         ids=["every1", "every2_tail", "tail_only"])
def test_init_tree_matches_jax(n, every):
    """The port's seeded init has the JAX package's tree: the super-blocks
    ``(n_super, every, ...)`` or None, the tail ``(n_tail, ...)`` or None,
    one shared dense block at the real attention dims; and its
    ``param_count``."""
    jcfg, cfg = _configs(n, every, vertical=False)
    n_super, n_tail = tfm.hybrid_layout(n, every)
    assert (n_super, n_tail) == jax_tfm.hybrid_layout(n, every)
    params = backbone.init_params(cfg, device="cpu")
    jshapes = jax.eval_shape(lambda k: jax_backbone.init_params(jcfg, k),
                             jax.random.PRNGKey(0))
    assert _shapes(params) == _shapes(jshapes)
    assert (params["server_super"] is None) == (n_super == 0)
    assert (params["server_tail"] is None) == (n_tail == 0)
    assert backbone.param_count(cfg) == jax_backbone.param_count(jcfg)


@pytest.fixture(scope="module")
def five_layers():
    """One JAX init of a centralized 5-layer model at ``every`` 1: five
    Mamba2 layers (its ``(5, 1, ...)`` super-blocks) and the shared
    block, from which each layout's stacks are cut."""
    jcfg, _ = _configs(5, 1, vertical=False)
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(1))
    return jax.tree_util.tree_map(np.asarray, jparams)


def _layout_params(five, n, every):
    """The server of an ``n``-layer model at ``every``: its first
    ``n_super * every`` layers as ``(n_super, every, ...)`` super-blocks
    and the next ``n_tail`` as the tail (None when empty), the shared
    block as it is."""
    n_super, n_tail = jax_tfm.hybrid_layout(n, every)
    layers = jax.tree_util.tree_map(lambda a: a.reshape((5,) + a.shape[2:]),
                                    five["server_super"])
    cut = n_super * every
    return {
        "server_super": jax.tree_util.tree_map(
            lambda a: a[:cut].reshape((n_super, every) + a.shape[1:]),
            layers) if n_super else None,
        "server_tail": jax.tree_util.tree_map(
            lambda a: a[cut:cut + n_tail], layers) if n_tail else None,
        "shared_attn": five["shared_attn"]}


@pytest.mark.parametrize("n,every", LAYOUTS,
                         ids=["every1", "every2_tail", "tail_only"])
def test_hybrid_stack_apply_and_decode_match_jax(five_layers, n, every):
    """The server stack of a centralized model with ``n`` layers: the
    full-sequence output within 1e-5; then three one-token decode steps
    from empty caches: each step's output and the final caches within
    1e-5, the positions exactly (unchanged without a super-block)."""
    jcfg, cfg = _configs(n, every, vertical=False)
    npar = _layout_params(five_layers, n, every)
    jparams = jax.tree_util.tree_map(jnp.asarray, npar)
    params = params_from_numpy(npar, "cpu")
    jdims, dims = jax_tfm.BlockDims.from_arch(jcfg), \
        tfm.BlockDims.from_arch(cfg)
    x = np.random.default_rng(1).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_tfm.hybrid_stack_apply(
        p["server_super"], p["server_tail"], p["shared_attn"], x, jcfg.ssm,
        jdims, positions=jnp.arange(SEQ)))(jparams, jnp.asarray(x))
    got = tfm.hybrid_stack_apply(
        params["server_super"], params["server_tail"], params["shared_attn"],
        torch.from_numpy(x), cfg.ssm, dims,
        positions=torch.arange(SEQ))
    _close(got, want, SCAN_TOL)

    keys = ("ssm_super", "conv_super", "attn_k", "attn_v", "ssm_tail",
            "conv_tail")
    jcache = jax_backbone.init_cache(jcfg, 2, 8)
    cache = backbone.init_cache(cfg, 2, 8, device="cpu")
    assert _shapes(cache) == _shapes(jcache)

    def jstep(p, c, x, i):
        out = jax_tfm.hybrid_stack_decode(
            p["server_super"], p["server_tail"], p["shared_attn"], x,
            *(c.get(k) for k in keys), i, c["kv_positions"], jcfg.ssm, jdims,
            position=i)
        return out[0], dict(zip(keys, out[1:7])), out[7]

    jstep = jax.jit(jstep)
    xs = np.random.default_rng(2).standard_normal(
        (3, 2, 1, cfg.d_model)).astype(np.float32)
    jpos, pos = jcache["kv_positions"], cache["kv_positions"].expand(2, -1)
    for t in range(3):
        jx, jnew, jpos = jstep(jparams, dict(jcache, kv_positions=jpos),
                               jnp.asarray(xs[t]), jnp.int32(t))
        jcache.update({k: v for k, v in jnew.items() if v is not None})
        index = torch.full((2,), t)
        out = tfm.hybrid_stack_decode(
            params["server_super"], params["server_tail"],
            params["shared_attn"], torch.from_numpy(xs[t]),
            *(cache.get(k) for k in keys), index, pos, cfg.ssm, dims,
            position=index)
        pos = out[7]
        _close(out[0], jx, SCAN_TOL)
    for key in keys:
        assert (key in cache) == (key in jcache)
        if key in cache:
            _close(cache[key], jcache[key], SCAN_TOL)
    np.testing.assert_array_equal(to_numpy(pos)[0], np.asarray(jpos))
    if every > n:
        assert (to_numpy(pos) == -1).all()


def test_hybrid_stack_gradients_match_jax(five_layers):
    """Autograd through the nested ``(2, 2, ...)`` super-blocks, the shared
    block they all reuse and the tail (5 layers at ``every`` 2) against
    ``jax.grad`` of the JAX package's stack: the gradient of the output's
    sum with respect to every param and to the input, each within 1e-5
    of its largest entry (a weight gradient sums over every token)."""
    jcfg, cfg = _configs(5, 2, vertical=False)
    npar = _layout_params(five_layers, 5, 2)
    jdims, dims = jax_tfm.BlockDims.from_arch(jcfg), \
        tfm.BlockDims.from_arch(cfg)
    x = np.random.default_rng(3).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        return jax_tfm.hybrid_stack_apply(
            p["server_super"], p["server_tail"], p["shared_attn"], x,
            jcfg.ssm, jdims, positions=jnp.arange(SEQ)).sum()

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, npar), jnp.asarray(x))
    params = params_from_numpy(npar, "cpu")
    leaves = [t.requires_grad_(True) for t in jax.tree_util.tree_leaves(
        params)]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tfm.hybrid_stack_apply(
        params["server_super"], params["server_tail"], params["shared_attn"],
        xt, cfg.ssm, dims, positions=torch.arange(SEQ))
    got = torch.autograd.grad(out.sum(), leaves + [xt])
    wants = jax.tree_util.tree_leaves(want[0]) + [want[1]]
    assert len(got) == len(wants)
    for g, w in zip(got, wants):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))
