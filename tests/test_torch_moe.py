"""The moe family (deepseek-moe-16b, arctic-480b) against the JAX package.

- ``moe_apply`` on reduced widths (d_model 256, 4 experts, top-2): with a
  shared expert (deepseek), with a dense residual (arctic), over capacity
  (``capacity_factor`` 0.5), on 3 x 320 tokens (one group of 960, not a
  multiple of 512) and on 3 x 400 (two groups of 600, over capacity).
  Routes first: each token's top-k experts in slot order, then its
  queue positions and drops, then the aux loss, then the output.
- The moe block stack: full-sequence output and summed aux, then three
  one-token decode steps (outputs and caches).
- Reduced deepseek-moe-16b split and centralized (the centralized tree
  has ``server_dense``, a dense layer of FFN width ``d_ff * top_k``) and
  reduced arctic-480b: the init tree, ``param_count`` (and the full
  configs' counts), ``forward`` logits and aux, ``init_cache`` /
  ``decode_step``, greedy ``generate`` at B = 2 and the real capacity
  factor (each decode step routes the 2 streams' tokens as one group, a
  reference quirk the port copies; at capacity factor 0.5 it drops
  tokens there), a bf16 arctic tree (the router stays f32), and the
  refusals (split serving, the thin split helpers).

Inputs come from ``numpy.random.default_rng`` seeds; params from the
port's seeded init, carried to the JAX package by ``interop.to_numpy``
(the trees are the same: checked here at every config; the JAX
package's init compiles for seconds a model).  f32 tolerances:
an MoE output 1e-5, logits 1e-4 (``tests/test_torch_hybrid_model.py``'s
rule after a server), aux 1e-6, tokens exactly; bf16 logits (|logit| <
4) within 4 bf16 ulps at [2, 4) (``tests/test_torch_ssd.py``'s rule), the
bf16 aux within the limit its mean router probs' difference sets, and
greedy tokens equal up to a top-2 gap of 6e-2
(``tests/test_torch_dense_configs.py``'s).  Top-k routing is
discontinuous: where the two packages pick other experts for a token,
the test prints that token's top-k margin (the gap between its k-th and
(k+1)-th router probability) and fails unless the margin is below
``ROUTE_TOL``, a few f32 roundings of a probability.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import backbone as jax_backbone
from repro.models import moe as jax_moe
from repro.models import split_program as jax_split_program
from repro.models import transformer as jax_tfm
from repro.serve import decode as jax_decode
from repro_torch.configs.base import get_arch
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import backbone, moe, split_program
from repro_torch.models import transformer as tfm
from repro_torch.serve import generate

MOE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
AUX_TOL = dict(rtol=0, atol=1e-6)
BF16_LOGIT_TOL = dict(rtol=3e-2, atol=4 * 2.0 ** -6)
GAP = 6e-2
ROUTE_TOL = 1e-6
DEEPSEEK, ARCTIC = "deepseek-moe-16b", "arctic-480b"
SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(arch, vertical=True, **moe_kw):
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **moe_kw))
    if not vertical:
        jcfg, cfg = jcfg.with_vertical(None), cfg.with_vertical(None)
    return jcfg, cfg


def _to_jax(params):
    """The same tree for the JAX package, leaf for leaf in the same
    dtypes (bf16 through f32)."""
    leaves = jax.tree_util.tree_leaves(params)
    jleaves = [jnp.asarray(a).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                     else a.dtype)
               for t, a in zip(leaves, to_numpy(leaves))]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), jleaves)


def _carried(cfg, seed=0, dtype=torch.float32):
    """The port's seeded init in ``dtype`` (the routers f32) and the JAX
    package's copy of it."""
    params = backbone.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu", dtype=dtype)
    return _to_jax(params), params


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _shapes(tree):
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
        tree)


def _close(got, want, tol):
    got = to_numpy(got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b, dtype=np.float32), **tol)


@functools.partial(jax.jit, static_argnums=2)
def _jax_routes(router, x, cfg):
    """The reference's routing of ``x`` (B, S, d), line for line
    (``repro/models/moe.py``): probs, top-k experts and queue positions
    per group, and the capacity."""
    B, S, d = x.shape
    N = B * S
    G = max(1, N // 512)
    while N % G:
        G -= 1
    Sg = N // G
    probs = jax.nn.softmax(x.reshape(G, Sg, d).astype(jnp.float32) @ router,
                           axis=-1)
    _, top_idx = jax.lax.top_k(probs, cfg.top_k)
    onehot = jax.nn.one_hot(top_idx, cfg.num_experts, dtype=jnp.int32)
    flat = onehot.reshape(G, Sg * cfg.top_k, cfg.num_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat, axis=-1)
    return probs, top_idx, pos.reshape(G, Sg, cfg.top_k)


def _expect_same_routes(got_idx, want_idx, probs, k):
    """Top-k experts in slot order equal; where they differ, the token's
    top-k margin in the reference's probs is printed and must be below
    ``ROUTE_TOL``.  Returns the mask of tokens routed alike."""
    same = (got_idx == want_idx).all(-1)
    for g, s in zip(*np.nonzero(~same)):
        p = np.sort(probs[g, s])[::-1]
        margin = float(p[k - 1] - p[k]) if k < p.size else 0.0
        print(f"route flip at group {g} token {s}: port "
              f"{got_idx[g, s].tolist()} vs reference "
              f"{want_idx[g, s].tolist()}, top-k margin {margin:.3e}")
        assert margin <= ROUTE_TOL, margin
    return same


MOE_CASES = {
    # name: (arch, moe overrides, (B, S))
    "shared": (DEEPSEEK, {}, (2, SEQ)),
    "dense_residual": (ARCTIC, {}, (2, SEQ)),
    "over_capacity": (DEEPSEEK, dict(capacity_factor=0.5), (2, SEQ)),
    "n960": (DEEPSEEK, {}, (3, 320)),
    "two_groups": (ARCTIC, dict(capacity_factor=0.5), (3, 400)),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    """The routes, the queue positions and drops, the aux loss, then the
    output of one MoE FFN."""
    arch, kw, (B, S) = MOE_CASES[case]
    jcfg, cfg = _configs(arch, **kw)
    jmoe, tmoe = jcfg.moe, cfg.moe
    params = moe.init_moe(torch.Generator().manual_seed(1), cfg.d_model,
                          cfg.d_ff, tmoe)
    jp = _to_jax(params)
    assert ("shared" in params) == bool(tmoe.num_shared_experts)
    assert ("dense_residual" in params) == tmoe.dense_residual
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)

    probs, jidx, jpos = (np.asarray(a) for a in _jax_routes(
        jp["router"], jnp.asarray(x), jmoe))
    G = moe.num_groups_for(B * S)
    C = jax_moe._capacity(B * S // G, jmoe)
    assert (G, moe._capacity(B * S // G, tmoe)) == (probs.shape[0], C)
    xt = torch.from_numpy(x).reshape(G, -1, cfg.d_model)
    tprobs, _, tidx = moe.route(params["router"], xt, tmoe)
    np.testing.assert_allclose(tprobs.numpy(), probs, rtol=1e-6, atol=1e-7)
    same = _expect_same_routes(tidx.numpy(), jidx, probs, tmoe.top_k)
    pos = moe.queue_positions(torch.nn.functional.one_hot(
        tidx, tmoe.num_experts)).numpy()
    if same.all():
        np.testing.assert_array_equal(pos, jpos)
        drops = int((jpos >= C).sum())
        if kw.get("capacity_factor") == 0.5:
            assert drops > 0, "the over-capacity case dropped nothing"

    want, jaux = jax.jit(lambda p, x: jax_moe.moe_apply(p, x, jmoe))(
        jp, jnp.asarray(x))
    got, aux = moe.moe_apply(params, torch.from_numpy(x), tmoe)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), **AUX_TOL)
    _close(got, want, MOE_TOL)


def test_capacity_and_groups_match_jax():
    """The group count and the capacity at every token count the paths
    reach (decode batches, the training microbatches, the prefills)."""
    for arch in (DEEPSEEK, ARCTIC):
        jcfg, cfg = jax_get_arch(arch), get_arch(arch)
        for N in (1, 2, 8, 320, 960, 1024, 1200, 2048, 4096, 8192):
            G = max(1, N // 512)
            while N % G:
                G -= 1
            assert moe.num_groups_for(N) == G
            assert moe._capacity(N // G, cfg.moe) == \
                jax_moe._capacity(N // G, jcfg.moe)
    # decode at B <= 8 on deepseek-moe-16b: one slot per expert
    assert moe._capacity(2, get_arch(DEEPSEEK).moe) == 1
    for fn in ("moe_params_count", "moe_active_params_count"):
        for arch in (DEEPSEEK, ARCTIC):
            cfg = get_arch(arch)
            assert getattr(moe, fn)(cfg.d_model, cfg.d_ff, cfg.moe) == \
                getattr(jax_moe, fn)(cfg.d_model, cfg.d_ff,
                                     jax_get_arch(arch).moe)


def test_moe_stack_apply_and_decode_match_jax():
    """Two stacked MoE blocks of reduced deepseek-moe-16b (a shared
    expert each): the full-sequence output within 1e-5 and the aux summed
    over the layers within 1e-6; then three one-token decode steps of 2
    streams from empty caches: each step's output and the final caches
    within 1e-5, the positions exactly."""
    jcfg, cfg = _configs(DEEPSEEK, vertical=False)
    jdims, dims = jax_tfm.BlockDims.from_arch(jcfg), \
        tfm.BlockDims.from_arch(cfg)
    params = tfm.init_moe_block(torch.Generator().manual_seed(3), dims,
                                cfg.moe, lead=(2,))
    jp = _to_jax(params)
    x = np.random.default_rng(4).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32)
    want, jaux = jax.jit(lambda p, x: jax_tfm.moe_stack_apply(
        p, x, jdims, jcfg.moe, positions=jnp.arange(SEQ)))(
        jp, jnp.asarray(x))
    got, aux = tfm.moe_stack_apply(params, torch.from_numpy(x), dims,
                                   cfg.moe, positions=torch.arange(SEQ))
    _close(got, want, MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **AUX_TOL)

    shape = (2, 2, 8, dims.n_kv_heads, dims.head_dim)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    jpos = jnp.full((8,), -1, jnp.int32)
    pos = torch.full((2, 8), -1)
    jstep = jax.jit(lambda p, x, k, v, i, kp: jax_tfm.moe_stack_decode(
        p, x, k, v, i, kp, jdims, jcfg.moe, position=i))
    xs = np.random.default_rng(5).standard_normal(
        (3, 2, 1, cfg.d_model)).astype(np.float32)
    for t in range(3):
        jx, jk, jv, jpos = jstep(jp, jnp.asarray(xs[t]), jk, jv,
                                 jnp.int32(t), jpos)
        index = torch.full((2,), t)
        out, ck, cv, pos = tfm.moe_stack_decode(
            params, torch.from_numpy(xs[t]), ck, cv, index, pos, dims,
            cfg.moe, position=index)
        _close(out, jx, MOE_TOL)
    _close(ck, jk, MOE_TOL)
    _close(cv, jv, MOE_TOL)
    np.testing.assert_array_equal(pos.numpy()[0], np.asarray(jpos))


INIT_CASES = [(DEEPSEEK, True), (DEEPSEEK, False), (ARCTIC, True),
              (ARCTIC, False)]


@pytest.mark.parametrize("arch,vertical", INIT_CASES,
                         ids=["deepseek", "deepseek_central", "arctic",
                              "arctic_central"])
def test_init_tree_matches_jax(arch, vertical):
    """The port's seeded init has the JAX package's tree (``server_dense``
    only where a dense layer is left after the towers), f32 and bf16, the
    router f32 in both, and ``interop`` carries the JAX package's tree
    across leaf for leaf; and its ``param_count``."""
    jcfg, cfg = _configs(arch, vertical)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        params = backbone.init_params(cfg, device="cpu", dtype=dtype)
        jshapes = jax.eval_shape(
            lambda k: jax_backbone.init_params(jcfg, k, jdtype),
            jax.random.PRNGKey(0))
        assert _shapes(params) == _shapes(jshapes)
        assert params["server"]["moe"]["router"].dtype == torch.float32
        # the JAX package's tree carried across keeps every leaf's dtype
        carried = params_from_numpy(jax.tree_util.tree_map(
            lambda a: np.zeros(a.shape, a.dtype), jshapes), "cpu")
        assert _shapes(carried) == _shapes(jshapes)
    want_dense = arch == DEEPSEEK and not vertical
    assert ("server_dense" in params) == want_dense
    assert backbone.params_dense_layers(cfg) == \
        jax_backbone.params_dense_layers(jcfg) == int(want_dense)
    assert backbone.param_count(cfg) == jax_backbone.param_count(jcfg)


def test_param_count_of_the_full_configs():
    """``param_count`` of the full configs from shapes only (the ``meta``
    device), equal to the JAX package's."""
    want = {(DEEPSEEK, True): 15_721_809_920,
            (DEEPSEEK, False): 16_360_392_704,
            (ARCTIC, True): 449_803_174_912}
    for (arch, vertical), n in want.items():
        cfg = get_arch(arch)
        if not vertical:
            cfg = cfg.with_vertical(None)
        assert backbone.param_count(cfg) == n


@pytest.fixture(scope="module")
def models():
    """Reduced deepseek-moe-16b split and centralized, reduced arctic-480b
    split: (jcfg, cfg, jparams, params) each."""
    out = {}
    for name, arch, vertical in (("deepseek", DEEPSEEK, True),
                                 ("deepseek_central", DEEPSEEK, False),
                                 ("arctic", ARCTIC, True)):
        jcfg, cfg = _configs(arch, vertical)
        out[name] = (jcfg, cfg) + _carried(cfg)
    return out


@pytest.mark.parametrize("name", ["deepseek", "deepseek_central", "arctic"])
def test_forward_matches_jax(models, name):
    """Towers (dense), the avg merge, the server (deepseek centralized: its
    dense first layer, then the MoE layer), the head: logits within 1e-4
    and the aux loss within 1e-6; ``train_loss`` is the LM loss plus the
    aux."""
    jcfg, cfg, jparams, params = models[name]
    toks = _tokens(cfg, (2, SEQ), seed=3)
    want, jaux = jax.jit(lambda p, t: jax_backbone.forward(
        p, {"tokens": t}, jcfg))(jparams, jnp.asarray(toks))
    batch = {"tokens": torch.from_numpy(toks)}
    got, aux = backbone.forward(params, batch, cfg)
    _close(got, want, LOGIT_TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), **AUX_TOL)
    labels = torch.from_numpy(_tokens(cfg, (2, SEQ), seed=4))
    loss = backbone.train_loss(params, dict(batch, labels=labels), cfg)
    torch.testing.assert_close(
        loss, backbone.lm_loss(got, labels) + aux, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["deepseek", "deepseek_central"])
def test_decode_step_matches_jax(models, name):
    """The cache has the JAX package's keys and shapes (``dense_k`` /
    ``dense_v`` for the centralized model's dense layer; ``kv_quant`` is
    ignored for moe, as there); three steps into a prompt, every cache
    and the fourth step's logits agree, the positions exactly."""
    jcfg, cfg, jparams, params = models[name]
    jcache = jax_backbone.init_cache(jcfg, 2, 16)
    cache = backbone.init_cache(cfg, 2, 16, device="cpu")
    assert _shapes(cache) == _shapes(jcache)
    assert ("dense_k" in cache) == (name == "deepseek_central")
    assert _shapes(backbone.init_cache(cfg, 2, 16, kv_quant=True,
                                       device="cpu")) == _shapes(jcache)
    toks = _tokens(cfg, (2, 4), seed=4)
    step = jax.jit(lambda p, c, t: jax_backbone.decode_step(p, c, t, jcfg))
    for t in range(3):
        _, jcache = step(jparams, jcache, jnp.asarray(toks[:, t]))
        _, cache = backbone.decode_step(params, cache,
                                        torch.as_tensor(toks[:, t]), cfg)
    want, jnew = step(jparams, jcache, jnp.asarray(toks[:, 3]))
    got, new = backbone.decode_step(params, cache,
                                    torch.as_tensor(toks[:, 3]), cfg)
    _close(got, want, LOGIT_TOL)
    assert int(new["index"]) == int(jnew["index"]) == 4
    np.testing.assert_array_equal(to_numpy(new["kv_positions"]),
                                  np.asarray(jnew["kv_positions"]))
    for key in jnew:
        if key not in ("index", "kv_positions"):
            _close(new[key], jnew[key], LOGIT_TOL)


@pytest.mark.parametrize("name", ["deepseek", "deepseek_central", "arctic"])
def test_generate_matches_jax(models, name):
    """Greedy tokens of 2 prompts at the real capacity factor: the prompt
    replayed through ``decode_step``, as the JAX package's ``generate``
    does for moe.  Each step routes the 2 streams' tokens as one group
    (capacity ceil(2 * 2 / 4 * 1.25) = 2 slots an expert here), so a
    stream's tokens depend on its batch, in both packages alike."""
    jcfg, cfg, jparams, params = models[name]
    prompts = _tokens(cfg, (2, 6), seed=5)
    want = jax_decode.generate(jparams, jcfg, jnp.asarray(prompts),
                               max_new_tokens=6)
    got = generate(params, cfg, prompts, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_capacity_quirk_matches_jax():
    """The reference quirk at decode: with ``capacity_factor`` 0.5 each
    expert takes one token of the 2-stream batch (C = ceil(2 * 2 / 4 *
    0.5) = 1), so the second stream's token is dropped wherever both pick
    an expert, and a stream decoded beside another differs from the
    same stream decoded alone.  Both packages give the same tokens, batch
    by batch."""
    jcfg, cfg = _configs(DEEPSEEK, capacity_factor=0.5)
    jparams, params = _carried(cfg, seed=2)
    prompts = _tokens(cfg, (2, 6), seed=6)
    runs = []
    for rows in (slice(0, 2), slice(1, 2)):
        want = jax_decode.generate(jparams, jcfg, jnp.asarray(prompts[rows]),
                                   max_new_tokens=6)
        got = generate(params, cfg, prompts[rows], max_new_tokens=6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        runs.append(got.numpy())
    # the quirk shows at these inputs: stream 1 beside stream 0 is not
    # stream 1 alone
    assert not np.array_equal(runs[0][1], runs[1][0])


def _router_inputs(monkeypatch):
    """Record every ``moe_apply`` call's router weight and input, f32, in
    both packages: the port's directly, the JAX package's through a
    ``jax.debug.callback`` (its layers run inside ``lax.scan``)."""
    port, ref = [], []
    apply, japply = moe.moe_apply, jax_moe.moe_apply

    def recording(p, x, cfg, **kw):
        port.append((p["router"].float().numpy(), x.float().numpy()))
        return apply(p, x, cfg, **kw)

    def jrecording(p, x, cfg, **kw):
        jax.debug.callback(lambda r, h: ref.append((np.asarray(r),
                                                    np.asarray(h))),
                           p["router"], x.astype(jnp.float32), ordered=True)
        return japply(p, x, cfg, **kw)

    monkeypatch.setattr(moe, "moe_apply", recording)
    monkeypatch.setattr(jax_moe, "moe_apply", jrecording)
    return port, ref


def _softmax(z):
    z = np.exp(z - z.max(-1, keepdims=True))
    return z / z.sum(-1, keepdims=True)


def test_arctic_bf16_matches_jax(monkeypatch):
    """A bf16 tree of reduced arctic-480b (the router f32, carried across
    as f32): ``forward`` logits within 4 bf16 ulps of the JAX package's;
    then each MoE layer's routing from the two packages' own bf16 router
    inputs, which agree within 4 bf16 ulps too (here 3.1e-2 at most, 2
    ulps, for inputs up to 3.4): the top-1 experts equal (a flip is
    printed with its top-1 margin), and the aux loss within the limit
    those inputs set: with equal top-1 densities (which sum to 1), a
    layer's aux moves by at most E * weight * the largest difference of
    an expert's mean router prob (here the probs differ by up to 3.7e-3,
    the means by 3.7e-4, so the limit is 1.6e-5 with the 1e-6 of f32
    roundings; the aux differ by 5.7e-6); the first generated token
    equal to the JAX package's unless the top-2 gap there is 6e-2 or
    less."""
    jcfg, cfg = _configs(ARCTIC)
    jparams, params = _carried(cfg, dtype=torch.bfloat16)
    assert jparams["server"]["moe"]["router"].dtype == jnp.float32
    assert params["server"]["moe"]["router"].dtype == torch.float32
    assert params["server"]["moe"]["w_gate"].dtype == torch.bfloat16
    toks = _tokens(cfg, (2, 16), seed=3)
    port, ref = _router_inputs(monkeypatch)
    want, jaux = jax.jit(lambda p, t: jax_backbone.forward(
        p, {"tokens": t}, jcfg))(jparams, jnp.asarray(toks))
    jax.effects_barrier()
    got, aux = backbone.forward(params, {"tokens": torch.from_numpy(toks)},
                                cfg)
    monkeypatch.undo()
    assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
    ref_logits = np.asarray(want.astype(jnp.float32))
    assert np.abs(ref_logits).max() < 4
    np.testing.assert_allclose(to_numpy(got), ref_logits, **BF16_LOGIT_TOL)

    assert len(port) == len(ref) > 0
    limit = 1e-6
    for (router, x), (jrouter, jx) in zip(port, ref):
        np.testing.assert_array_equal(router, jrouter)
        assert np.abs(jx).max() < 4
        np.testing.assert_allclose(x, jx, **BF16_LOGIT_TOL)
        probs, jprobs = (_softmax(h.reshape(-1, h.shape[-1]) @ router)
                         for h in (x, jx))
        top, jtop = probs.argmax(-1), jprobs.argmax(-1)
        for n in np.nonzero(top != jtop)[0]:
            p = np.sort(jprobs[n])[::-1]
            print(f"top-1 flip at token {n}: port {top[n]} vs reference "
                  f"{jtop[n]}, top-1 margin {p[0] - p[1]:.3e}")
        assert (top == jtop).all()
        dmean = float(np.abs((probs - jprobs).mean(0)).max())
        print(f"router inputs differ by {np.abs(x - jx).max():.3e} (largest "
              f"{np.abs(jx).max():.3e}), router probs by "
              f"{np.abs(probs - jprobs).max():.3e}, an expert's mean prob "
              f"by {dmean:.3e}")
        limit += cfg.moe.num_experts * cfg.moe.router_aux_weight * dmean
    print(f"aux {float(aux):.8f} vs {float(jaux):.8f}, |diff| "
          f"{abs(float(aux) - float(jaux)):.3e}, limit {limit:.3e}")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=limit)
    jtoks = np.asarray(jax_decode.generate(
        jparams, jcfg, jnp.asarray(toks[:, :8]), max_new_tokens=1))
    toks_ = generate(params, cfg, toks[:, :8], max_new_tokens=1).numpy()
    # the first generated token follows the logits at prompt position 7
    top2 = np.sort(ref_logits[:, 7], -1)[:, -2:]
    for row in range(2):
        assert toks_[row, 0] == jtoks[row, 0] or \
            top2[row, 1] - top2[row, 0] <= GAP


def test_split_serving_and_thin_helpers_refused_as_in_jax():
    """Split serving stays dense-only with the JAX package's reason; the
    thin ``make_split_lm_fns`` refuses a program with an aux slot, as
    there; the prompt prefill stays dense-only (generate replays)."""
    jcfg, cfg = _configs(DEEPSEEK)
    prog, jprog = (split_program.get_program(cfg),
                   jax_split_program.get_program(jcfg))
    assert prog.has_aux and jprog.has_aux
    assert prog.executor_kwargs == dict(server_takes_batch=False,
                                        server_aux=True, merge_fn=None)
    for fns in ("tower_serve_fns", "server_serve_fns"):
        args = (0,) if fns == "tower_serve_fns" else ()
        with pytest.raises(NotImplementedError) as got:
            getattr(prog, fns)(*args)
        with pytest.raises(NotImplementedError) as want:
            getattr(jprog, fns)(*args)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="aux-loss slot"):
        backbone.make_split_lm_fns(cfg)
    with pytest.raises(ValueError, match="aux-loss slot"):
        jax_backbone.make_split_lm_fns(jcfg)
    with pytest.raises(NotImplementedError, match="replays the prompt"):
        backbone.prefill_tokens({}, backbone.init_cache(cfg, 1, 4,
                                                        device="cpu"),
                                torch.zeros((1, 2), dtype=torch.long), cfg)


def test_executor_takes_the_aux_slot_and_refuses_the_rest():
    """The Executor takes ``server_aux`` programs, and the audio and vlm
    families' program shapes (``server_takes_batch``, ``merge_fn``); what
    it refuses is a program ``merge_fn`` under EMA imputation, secure
    aggregation, compression or a tree, with the JAX package's words."""
    from repro.core import compat as jax_compat
    from repro.runtime.executor import Executor as JaxExecutor
    from repro.runtime.topology import AggTree as JaxAggTree
    from repro.transport.base import SimTransport as JaxSimTransport
    from repro.transport.base import TowerWorker as JaxTowerWorker
    from repro_torch.core import compat
    from repro_torch.runtime.executor import Executor
    from repro_torch.runtime.topology import AggTree
    from repro_torch.transport import SimTransport, TowerWorker

    def merge_fn(cuts, mask):
        return cuts[0]

    args = (SimTransport([TowerWorker(k, None, {}) for k in range(2)]),
            None, None, "avg")
    jargs = (JaxSimTransport([JaxTowerWorker(k, None, {})
                              for k in range(2)]), None, None, "avg")
    assert Executor(*args, mode="serial", server_aux=True).server_aux
    ex = Executor(*args, mode="serial", server_takes_batch=True,
                  merge_fn=merge_fn)
    assert ex.server_takes_batch and ex.merge_fn is merge_fn
    for kw, jkw in ((dict(mode="nowait"),) * 2, (dict(secure_agg=True),) * 2,
                    (dict(compress="int8"),) * 2,
                    (dict(agg_tree=AggTree(2, fanout=2)),
                     dict(agg_tree=JaxAggTree(2, fanout=2)))):
        with pytest.raises(compat.CompatError) as got:
            Executor(*args, merge_fn=merge_fn, **kw)
        with pytest.raises(jax_compat.CompatError) as want:
            JaxExecutor(*jargs, merge_fn=merge_fn, **jkw)
        assert str(got.value) == str(want.value)
