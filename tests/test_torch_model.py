"""The port's dense model stack against the JAX package, on reduced
smollm-360m with the JAX package's params carried across by ``interop``.

Inputs are made from a seed with numpy and fed to both packages.  f32
throughout; atol 1e-5 (rtol 1e-5 for the larger activations) — the two
packages sum in different orders, nothing else differs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import backbone as jax_backbone
from repro.models import split_program as jax_split_program
from repro.models import transformer as jax_tfm
from repro_torch.configs.base import get_arch
from repro_torch.interop import params_from_numpy, tensor_from_numpy, to_numpy
from repro_torch.models import backbone, split_program
from repro_torch.models import transformer as tfm

ARCH = "smollm-360m"
TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_LEN = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_arch(ARCH).reduced()
    cfg = get_arch(ARCH).reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jcfg, cfg, jparams, params


def _close(got, want):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    """Every field of the port's configs of smollm-360m, starcoder2-3b,
    stablelm-3b, qwen3-32b, mamba2-1.3b, zamba2-7b, deepseek-moe-16b,
    arctic-480b, whisper-tiny and internvl2-26b (sub-configs field by
    field, the encdec and vlm ones included) equals the JAX package's,
    and so do the block dims (the MLP and norm kinds included) and their
    tower scaling."""
    for arch in (ARCH, "starcoder2-3b", "stablelm-3b", "qwen3-32b",
                 "mamba2-1.3b", "zamba2-7b", "deepseek-moe-16b",
                 "arctic-480b", "whisper-tiny", "internvl2-26b"):
        jcfg, cfg = jax_get_arch(arch), get_arch(arch)
        if reduced:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        for f in dataclasses.fields(cfg):
            mine, theirs = getattr(cfg, f.name), getattr(jcfg, f.name)
            if dataclasses.is_dataclass(mine) or dataclasses.is_dataclass(
                    theirs):
                assert dataclasses.asdict(mine) == dataclasses.asdict(
                    theirs), (arch, f.name)
            else:
                assert mine == theirs, (arch, f.name)
        assert cfg.resolved_head_dim() == jcfg.resolved_head_dim()
        assert cfg.is_attention_free == jcfg.is_attention_free
        if cfg.ssm is not None:
            for d in (cfg.d_model, cfg.d_model // cfg.vertical.num_clients):
                assert (cfg.ssm.d_inner(d), cfg.ssm.n_heads(d)) == (
                    jcfg.ssm.d_inner(d), jcfg.ssm.n_heads(d))
        assert tfm.BlockDims.from_arch(cfg).__dict__ == \
            jax_tfm.BlockDims.from_arch(jcfg).__dict__
        assert tfm.BlockDims.from_arch(cfg).scaled(4).__dict__ == \
            jax_tfm.BlockDims.from_arch(jcfg).scaled(4).__dict__


@pytest.mark.parametrize("merge", ["avg", "concat"])
def test_init_params_shapes_and_scales(merge):
    """The port's seeded init draws the JAX package's tree: same keys, same
    shapes, same scales (the numbers differ — torch and jax draw apart)."""
    jcfg, cfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jcfg = jcfg.with_vertical(dataclasses.replace(jcfg.vertical, merge=merge))
    cfg = cfg.with_vertical(dataclasses.replace(cfg.vertical, merge=merge))
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jax.eval_shape(
            lambda: jax_backbone.init_params(jcfg, jax.random.PRNGKey(0))))
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = backbone.init_params(cfg, gen, device="cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert shapes == jshapes
    wq = params["server"]["attn"]["wq"]
    # truncated normal at +-2 has std 0.8796; fan-in scale 1/sqrt(d_in)
    std = float(wq.std()) * np.sqrt(wq.shape[-2])
    assert abs(std - 0.8796) < 0.03
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(wq.shape[-2]) + 1e-6
    assert abs(float(params["embed"]["table"].std()) - 0.02) < 0.002


@pytest.mark.parametrize("part", ["tower", "server"])
def test_stack_prefill_and_decode_match_jax(setup, part):
    jcfg, cfg, jparams, params = setup
    if part == "tower":
        jdims = jax_backbone._tower_dims(jcfg)
        dims = backbone._tower_dims(cfg)
        jstack = jax.tree_util.tree_map(lambda a: a[1],
                                        jparams["towers"]["blocks"])
        stack = tfm.layer_params(params["towers"]["blocks"], 1)
    else:
        jdims = jax_tfm.BlockDims.from_arch(jcfg)
        dims = tfm.BlockDims.from_arch(cfg)
        jstack, stack = jparams["server"], params["server"]
    B, S = 2, 7
    x = _rand((B, S, dims.d_model), 1)
    pos = np.arange(S, dtype=np.int32)
    jx, jks, jvs = jax_tfm.dense_stack_prefill(jstack, jnp.asarray(x), jdims,
                                               positions=jnp.asarray(pos))
    tx, ks, vs = tfm.dense_stack_prefill(stack, torch.from_numpy(x), dims,
                                         positions=torch.arange(S))
    _close(tx, jx)
    _close(ks, jks)
    _close(vs, jvs)

    # one decode step at index S against a cache holding the prefill K/V
    L = ks.shape[0]
    shape = (L, B, CACHE_LEN, dims.n_kv_heads, dims.head_dim)
    jk = jnp.zeros(shape).at[:, :, :S].set(jks)
    jv = jnp.zeros(shape).at[:, :, :S].set(jvs)
    jpos = jnp.full((CACHE_LEN,), -1, jnp.int32).at[:S].set(jnp.asarray(pos))
    x1 = _rand((B, 1, dims.d_model), 2)
    jout, jnk, jnv, jnpos, _ = jax_tfm.dense_stack_decode(
        jstack, jnp.asarray(x1), jk, jv, jnp.asarray(S, jnp.int32), jpos,
        jdims, position=jnp.asarray(S, jnp.int32))
    index = torch.full((B,), S)
    tout, nk, nv, npos, _ = tfm.dense_stack_decode(
        stack, torch.from_numpy(x1), tensor_from_numpy(jk, "cpu"),
        tensor_from_numpy(jv, "cpu"),
        index, tensor_from_numpy(jpos, "cpu").long().expand(B, -1),
        dims, position=index)
    _close(tout, jout)
    _close(nk, jnk)
    _close(nv, jnv)
    for b in range(B):
        np.testing.assert_array_equal(to_numpy(npos[b]), np.asarray(jnpos))


def test_split_program_serving_matches_jax(setup):
    """Tower and server prefill/decode of the split program, step by step,
    feeding each package its own outputs."""
    jcfg, cfg, jparams, params = setup
    jprog = jax_split_program.get_program(jcfg)
    prog = split_program.get_program(cfg)
    jtowers, jserver = jprog.partition(jparams)
    towers, server = prog.partition(params)
    S, n_steps = 6, 4
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, S))
    steps = np.random.default_rng(4).integers(0, cfg.vocab_size, n_steps)

    K = cfg.vertical.num_clients
    jtfns = [jprog.tower_serve_fns(k) for k in range(K)]
    tfns = [prog.tower_serve_fns(k) for k in range(K)]
    jcuts, cuts, jsess, sess = [], [], [], []
    for k, (jfns, fns) in enumerate(zip(jtfns, tfns)):
        jc, js = jfns.prefill(jtowers[k], jnp.asarray(tokens, jnp.int32),
                              CACHE_LEN)
        tc, ts = fns.prefill(towers[k], torch.from_numpy(tokens), CACHE_LEN)
        _close(tc, jc)
        _close(ts["k"], js["k"])
        assert int(ts["index"]) == int(js["index"]) == S
        jcuts.append(jc)
        cuts.append(tc)
        jsess.append(js)
        sess.append(ts)

    jsfns, sfns = jprog.server_serve_fns(), prog.server_serve_fns()
    jmerged = jnp.mean(jnp.stack(jcuts), axis=0)
    merged = torch.stack(cuts).mean(0)
    jlog, jcache = jsfns.prefill(jserver, jsfns.init_cache(CACHE_LEN),
                                 jmerged)
    tlog, cache = sfns.prefill(server, sfns.init_cache(CACHE_LEN), merged)
    _close(tlog, jlog)

    for tok in steps:
        jcuts, cuts = [], []
        for k, (jfns, fns) in enumerate(zip(jtfns, tfns)):
            jc, jsess[k] = jfns.decode(jtowers[k], jsess[k],
                                       jnp.asarray([tok], jnp.int32))
            tc, sess[k] = fns.decode(towers[k], sess[k],
                                     torch.tensor([int(tok)]))
            _close(tc, jc)
            jcuts.append(jc)
            cuts.append(tc)
        jlog, jcache = jsfns.decode(jserver, jcache,
                                    jnp.mean(jnp.stack(jcuts), axis=0))
        tlog, cache = sfns.decode(server, cache, torch.stack(cuts).mean(0))
        _close(tlog, jlog)
        assert int(cache["index"]) == int(jcache["index"])
        np.testing.assert_array_equal(to_numpy(cache["kv_positions"][0]),
                                      np.asarray(jcache["kv_positions"]))


def test_long_prefill_names_the_flash_slice():
    """Past FLASH_THRESHOLD**2 the JAX package takes its blocked flash
    path, and so does the port (the flash-attention slice): on the CPU its
    chunked path with the JAX package's chunk (410 at S = 2050), on the
    card the flash kernel.  Same params, same output at 1e-5."""
    from repro.models import attention as jax_attention
    from repro_torch.models import attention

    S = attention.FLASH_THRESHOLD + 2
    rng = np.random.default_rng(7)
    params = {name: (rng.standard_normal((8, 8)) * 0.3).astype(np.float32)
              for name in ("wq", "wk", "wv", "wo")}
    x = rng.standard_normal((1, S, 8)).astype(np.float32)
    want, _ = jax_attention.attention_apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        n_heads=1, n_kv_heads=1, head_dim=8)
    got, _ = attention.attention_apply(
        params_from_numpy(params, "cpu"), torch.from_numpy(x), n_heads=1,
        n_kv_heads=1, head_dim=8)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)
