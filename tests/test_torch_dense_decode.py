"""The port's dense monolithic decode against the JAX package: the decode
cache (linear, ring, int8), int8 KV quantization, flash-decoding chunks,
the prompt prefill (``prefill_tokens``) and step-by-step ``decode_step``
sequences under every decode knob, on reduced smollm-360m (2 layers,
d_model 256, K = 2 towers of one layer) with the JAX package's params
carried across by ``interop``.

Inputs are made from ``numpy.random.default_rng`` seeds and fed to both
packages.  f32 throughout; 1e-5 absolute on logits and caches (the two
packages sum in different orders, nothing else differs); int8 caches
exactly, their scales within 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import attention as jax_attention
from repro.models import backbone as jax_backbone
from repro_torch.configs.base import get_arch
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import attention, backbone

ARCH = "smollm-360m"
TOL = dict(rtol=0, atol=1e-5)
SCALE_TOL = dict(rtol=0, atol=1e-7)
B = 2

# (name, cache_len, steps, decode knobs, cache knobs, live mask): the ring
# case is the JAX package's own (tests/test_decode_equiv.py: S 12, W 4)
DECODE_CASES = [
    ("linear", 12, 12, {}, {}, None),
    ("window", 12, 12, {"window": 4}, {}, None),
    ("ring", 4, 12, {"window": 4, "ring": True}, {"ring": True}, None),
    ("kv_quant", 12, 12, {}, {"kv_quant": True}, None),
    ("chunks2", 12, 12, {"decode_chunks": 2}, {}, None),
    ("chunks4", 12, 12, {"decode_chunks": 4}, {}, None),
    ("kv_quant_chunks4", 12, 12, {"decode_chunks": 4}, {"kv_quant": True},
     None),
    ("live_mask", 12, 12, {}, {}, [0.0, 1.0]),
]


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


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _shapes(tree):
    """(shape, dtype name) per leaf, of a JAX or a torch tree."""
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
        tree)


def _close_cache(cache, jcache):
    """Every tensor of the two caches: int8 and integer leaves exactly,
    scales within 1e-7, float K/V within 1e-5."""
    got = jax.tree_util.tree_leaves_with_path(to_numpy(cache))
    want = dict(jax.tree_util.tree_leaves_with_path(jcache))
    assert len(got) == len(want)
    for path, a in got:
        b = np.asarray(want[path])
        assert a.shape == b.shape, path
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        elif "scale" in jax.tree_util.keystr(path):
            np.testing.assert_allclose(a, b, **SCALE_TOL, err_msg=str(path))
        else:
            np.testing.assert_allclose(a, b, **TOL, err_msg=str(path))


@pytest.mark.parametrize("knobs", [{}, {"ring": True}, {"kv_quant": True}],
                         ids=["linear", "ring", "kv_quant"])
def test_init_cache_matches_jax(setup, knobs):
    jcfg, cfg, _, _ = setup
    cache = backbone.init_cache(cfg, 3, 20, device="cpu", **knobs)
    jcache = jax_backbone.init_cache(jcfg, 3, 20, **knobs)
    assert _shapes(cache) == _shapes(jcache)
    _close_cache(cache, jcache)


def test_quantize_kv_matches_jax():
    """int8 exactly, scales within 1e-7; a row of zeros takes the 1e-8
    floor, a value at exactly half a step rounds to even."""
    x = np.random.default_rng(0).standard_normal((4, 8, 2, 64)).astype(
        np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 0, :] = 0.0
    x[0, 1, 0, 0], x[0, 1, 0, 1] = 127.0, 2.5  # scale 1: 2.5 -> 2
    jq, js = jax_attention.quantize_kv(jnp.asarray(x))
    q, s = attention.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **SCALE_TOL)
    assert int(q[0, 1, 0, 1]) == 2
    np.testing.assert_allclose(
        attention.dequantize_kv(q, s).numpy(),
        np.asarray(jax_attention.dequantize_kv(jq, js)), **SCALE_TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_chunked_decode_attention_matches_jax(window):
    """One stream at a time against the JAX package's scalar-position
    form: a chunk of unwritten slots (position -1) and, with the window,
    a chunk wholly outside it take zero weight; int8 K/V with scales."""
    rng = np.random.default_rng(1)
    S, Kv, H, hd = 16, 2, 4, 8
    q = rng.standard_normal((1, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((1, S, Kv, hd)).astype(np.float32)
    v = rng.standard_normal((1, S, Kv, hd)).astype(np.float32)
    kpos = np.arange(S, dtype=np.int32)
    kpos[12:] = -1  # the last chunk of four is unwritten
    position = 11
    for scales in (False, True):
        jk, jv, jsc, sc = jnp.asarray(k), jnp.asarray(v), None, None
        if scales:
            (kq, ks), (vq, vs) = (jax_attention.quantize_kv(jnp.asarray(a))
                                  for a in (k, v))
            jk, jv, jsc = kq, vq, (ks, vs)
            sc = tuple(torch.from_numpy(np.array(a)) for a in (ks, vs))
        want = jax_attention.chunked_decode_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(kpos), position, n_chunks=4,
            window=window, kv_scales=jsc)
        got = attention.chunked_decode_attention(
            torch.from_numpy(q), torch.from_numpy(np.array(jk)),
            torch.from_numpy(np.array(jv)), torch.from_numpy(kpos)[None],
            torch.tensor([position]), n_chunks=4, window=window,
            kv_scales=sc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_tokens_matches_jax(setup):
    """Logits of the last position and every cache tensor (the server's
    and the towers' K/V, the positions, the index)."""
    jcfg, cfg, jparams, params = setup
    toks = _tokens(cfg, (B, 7), seed=2)
    want, jcache = jax.jit(lambda p, c, t: jax_backbone.prefill_tokens(
        p, c, t, jcfg))(jparams, jax_backbone.init_cache(jcfg, B, 12),
                        jnp.asarray(toks))
    got, cache = backbone.prefill_tokens(
        params, backbone.init_cache(cfg, B, 12, device="cpu"),
        torch.as_tensor(toks), cfg)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)
    _close_cache(cache, jcache)
    assert int(cache["index"]) == 7


@pytest.mark.parametrize("name,cache_len,steps,knobs,cache_knobs,live",
                         DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_sequence_matches_jax(setup, name, cache_len, steps, knobs,
                                     cache_knobs, live):
    """``steps`` decode steps from an empty cache, each step's logits and
    the final cache against the JAX package's."""
    jcfg, cfg, jparams, params = setup
    toks = _tokens(cfg, (B, steps), seed=3)
    jlive = None if live is None else jnp.asarray(live, jnp.float32)
    tlive = None if live is None else torch.tensor(live)
    step = jax.jit(lambda p, c, t: jax_backbone.decode_step(
        p, c, t, jcfg, live_mask=jlive, **knobs))
    jcache = jax_backbone.init_cache(jcfg, B, cache_len, **cache_knobs)
    cache = backbone.init_cache(cfg, B, cache_len, device="cpu",
                                **cache_knobs)
    for t in range(steps):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[:, t]))
        got, cache = backbone.decode_step(params, cache,
                                          torch.as_tensor(toks[:, t]), cfg,
                                          live_mask=tlive, **knobs)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL,
                                   err_msg=f"{name} step {t}")
    _close_cache(cache, jcache)
    assert int(cache["index"]) == steps


def test_prefill_matches_stepwise(setup):
    """The fused prompt prefill agrees with a token-by-token replay of
    the prompt: logits, the filled K/V slots and the positions (as the
    JAX package's ``tests/test_system.py`` holds its own)."""
    _, cfg, _, params = setup
    toks = torch.as_tensor(_tokens(cfg, (B, 6), seed=4))
    fused, cf = backbone.prefill_tokens(
        params, backbone.init_cache(cfg, B, 10, device="cpu"), toks, cfg)
    cs = backbone.init_cache(cfg, B, 10, device="cpu")
    for t in range(6):
        stepped, cs = backbone.decode_step(params, cs, toks[:, t], cfg)
    np.testing.assert_allclose(to_numpy(fused), to_numpy(stepped), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_numpy(cf[key]), to_numpy(cs[key]),
                                   **TOL)
        np.testing.assert_allclose(to_numpy(cf["tower"][key]),
                                   to_numpy(cs["tower"][key]), **TOL)
    assert torch.equal(cf["kv_positions"], cs["kv_positions"])
    assert int(cf["index"]) == int(cs["index"]) == 6


def test_refusals(setup):
    """What the port leaves out raises by name: ``chunk_sharding`` (an
    XLA sharding constraint), a prefill into an int8 cache (the JAX
    package casts unscaled), and a prompt longer than the cache (the JAX
    package fails at trace time)."""
    _, cfg, _, params = setup
    toks = torch.as_tensor(_tokens(cfg, (1, 6), seed=5))
    cache = backbone.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="chunk_sharding"):
        backbone.decode_step(params, cache, toks[:, 0], cfg,
                             decode_chunks=2, chunk_sharding=object())
    with pytest.raises(NotImplementedError, match="int8"):
        backbone.prefill_tokens(
            params, backbone.init_cache(cfg, 1, 8, kv_quant=True,
                                        device="cpu"), toks, cfg)
    with pytest.raises(ValueError, match="6 tokens .* 4 slots"):
        backbone.prefill_tokens(
            params, backbone.init_cache(cfg, 1, 4, ring=True, device="cpu"),
            toks, cfg)
    with pytest.raises(ValueError, match="must divide"):
        backbone.decode_step(params, cache, toks[:, 0], cfg,
                             decode_chunks=3)


def test_init_cache_defaults_to_cuda(setup):
    """Without device="cpu" the cache wants the card, and raises where
    there is none — never a silent fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    _, cfg, _, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backbone.init_cache(cfg, 1, 8)
