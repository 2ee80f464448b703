"""The port's monolithic ``generate`` and ``batched_throughput_probe``
against the JAX package, on reduced smollm-360m (2 layers, d_model 256,
K = 2 towers of one layer) with the JAX package's params carried across
by ``interop``: greedy tokens of the dense family (linear cache, and a
window over a ring cache) and of the ssm family with the same knobs, a
bf16 tree, a 2304-token prompt through ``prefill_tokens`` (the chunked
attention on both sides), the port's ``generate`` against its own
``SplitLMServer``, and the refusals.

Prompts come from ``numpy.random.default_rng`` seeds.  Only greedy tokens
are compared: sampling draws from torch generators, which cannot
reproduce ``jax.random``.  f32 logits within 1e-5 absolute; bf16 logits
within 3e-2 and greedy tokens equal wherever the JAX package's top-2
logit gap exceeds 6e-2 (the repo's bf16 rules, ``tests/test_torch_bf16.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import backbone as jax_backbone
from repro.serve import decode as jax_decode
from repro_torch.configs.base import get_arch
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import backbone, split_program
from repro_torch.serve import (SplitLMServer, batched_throughput_probe,
                               generate)
from repro_torch.transport import SimTransport, build_split_worker

ARCH = "smollm-360m"
TOL = dict(rtol=0, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
ROPE_TOL = dict(rtol=0, atol=5e-4)  # RoPE'd past 2048 positions
GAP = 6e-2
LONG_PROMPT = 2304


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _carried(arch, dtype=jnp.float32):
    jcfg = jax_get_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), dtype)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def setup():
    return _carried(ARCH)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("knobs", [
    dict(max_new_tokens=7),
    dict(max_new_tokens=10, cache_len=8, window=8, ring=True),
], ids=["linear", "window_ring"])
def test_generate_matches_jax(setup, knobs):
    """Dense greedy tokens: the fused prefill, then decode steps; the ring
    case wraps its 8 slots twice over (6 prompt + 10 new tokens)."""
    jcfg, cfg, jparams, params = setup
    prompts = _tokens(cfg, (3, 6), seed=0)
    want = jax_decode.generate(jparams, jcfg, jnp.asarray(prompts), **knobs)
    got = generate(params, cfg, prompts, **knobs)
    assert got.shape == want.shape and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ssm_generate_takes_window_and_ring():
    """The ssm family accepts the decode knobs and, as in the JAX package,
    its recurrence ignores them: a ring cache of 4 slots, past which the
    prompt runs, gives the JAX package's tokens."""
    jcfg, cfg, jparams, params = _carried("mamba2-1.3b")
    prompts = _tokens(cfg, (2, 5), seed=1)
    knobs = dict(max_new_tokens=3, cache_len=4, window=4, ring=True)
    want = jax_decode.generate(jparams, jcfg, jnp.asarray(prompts), **knobs)
    got = generate(params, cfg, prompts, **knobs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_bf16_matches_jax():
    """A bf16 param tree over the f32 cache ``generate`` makes (as the
    JAX package's does): the towers' ``proj_in``/``proj_out`` and every
    weight product promote as ``jnp`` does.  Along the JAX package's
    greedy tokens, the port's prefill and decode logits stay within the
    repo's bf16 tolerance (3e-2) at every step, and each row's generated
    tokens equal the JAX package's up to its first step whose top-2 logit
    gap is 6e-2 or less (past such a near-tie the two runs may part)."""
    jcfg, cfg, jparams, params = _carried(ARCH, jnp.bfloat16)
    prompts = _tokens(cfg, (3, 8), seed=2)
    new = 6
    want = np.asarray(jax_decode.generate(jparams, jcfg, jnp.asarray(prompts),
                                          max_new_tokens=new))
    got = generate(params, cfg, prompts, max_new_tokens=new)
    assert got.shape == (3, new)
    # both packages' logits at each generated position: the prefill, then
    # the JAX package's tokens through each one's decode step
    jcache = jax_backbone.init_cache(jcfg, 3, 8 + new)
    jlogits, jcache = jax.jit(lambda p, c, t: jax_backbone.prefill_tokens(
        p, c, t, jcfg))(jparams, jcache, jnp.asarray(prompts))
    logits, cache = backbone.prefill_tokens(
        params, backbone.init_cache(cfg, 3, 8 + new, device="cpu"),
        torch.as_tensor(prompts), cfg)
    step = jax.jit(lambda p, c, t: jax_backbone.decode_step(p, c, t, jcfg))
    gaps = []
    for t in range(new):
        ref = np.asarray(jlogits.astype(jnp.float32))
        np.testing.assert_allclose(to_numpy(logits), ref, **BF16_TOL,
                                   err_msg=f"step {t}")
        top2 = np.sort(ref, -1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        jlogits, jcache = step(jparams, jcache, jnp.asarray(want[:, t]))
        logits, cache = backbone.decode_step(
            params, cache, torch.as_tensor(want[:, t].copy()), cfg)
    gaps = np.stack(gaps, axis=1)  # (3, new)
    for row in range(3):
        for t in range(new):
            if gaps[row, t] <= GAP:
                break
            assert int(got[row, t]) == int(want[row, t]), (row, t)


def test_long_prompt_prefill_matches_jax(setup):
    """A 2304-token prompt (past the 2048 threshold, so both packages take
    their chunked attention on the CPU; the card runs the flash kernel
    there): the last logits and the towers' V caches within 1e-5, the
    positions exactly, and the other caches within 5e-4.  Those carry
    RoPE (the K rows) or come after an attention over RoPE'd keys (the
    server's V), and the JAX package's RoPE compiled inside its layer
    scan differs from its own eager RoPE (which the port matches within
    2e-6) by up to 1e-3 at positions near 2300 on |x| of 16: the f32 sin
    and cos of angles past 2000 radians are evaluated differently once
    fused.  Here the K caches (|K| <= 4.3) differ by 1.7e-4."""
    jcfg, cfg, jparams, params = setup
    prompt = _tokens(cfg, (1, LONG_PROMPT), seed=3)
    cache_len = LONG_PROMPT + 2
    want, jcache = jax.jit(lambda p, c, t: jax_backbone.prefill_tokens(
        p, c, t, jcfg))(jparams, jax_backbone.init_cache(jcfg, 1, cache_len),
                        jnp.asarray(prompt))
    got, cache = backbone.prefill_tokens(
        params, backbone.init_cache(cfg, 1, cache_len, device="cpu"),
        torch.as_tensor(prompt), cfg)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_numpy(cache[key]),
                                   np.asarray(jcache[key]), **ROPE_TOL)
        np.testing.assert_allclose(to_numpy(cache["tower"][key]),
                                   np.asarray(jcache["tower"][key]),
                                   **(TOL if key == "v" else ROPE_TOL))
    np.testing.assert_array_equal(to_numpy(cache["kv_positions"]),
                                  np.asarray(jcache["kv_positions"]))


def test_generate_matches_split_server(setup):
    """The port's monolithic ``generate`` and its ``SplitLMServer`` (K = 2
    tower workers, continuous batching over 2 slots) give the same greedy
    tokens, request by request."""
    _, cfg, _, params = setup
    rng = np.random.default_rng(4)
    lens, new = [8, 5, 12, 7], [6, 9, 4, 8]
    prompts = [rng.integers(0, cfg.vocab_size, s) for s in lens]
    _, server = split_program.get_program(cfg).partition(params)
    workers = [build_split_worker(k, cfg=cfg, params=params, device="cpu")
               for k in range(cfg.vertical.num_clients)]
    srv = SplitLMServer(SimTransport(workers), cfg, server, device="cpu",
                        cache_len=32, max_batch=2)
    for p, n in zip(prompts, new):
        srv.submit(p, max_new_tokens=n)
    split = [r.tokens for r in srv.run()]
    mono = [generate(params, cfg, p[None], max_new_tokens=n)[0].tolist()
            for p, n in zip(prompts, new)]
    assert split == mono


def test_generate_rejects_overflowing_cache_len(setup):
    """A linear cache that cannot hold prompt and new tokens is refused
    (as ``tests/test_split_serve.py`` holds the JAX package); a ring
    cache of the same size wraps by design."""
    _, cfg, _, params = setup
    prompts = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="cache_len"):
        generate(params, cfg, prompts, max_new_tokens=8, cache_len=12)
    toks = generate(params, cfg, prompts, max_new_tokens=8, cache_len=12,
                    ring=True)
    assert toks.shape == (1, 8)
    with pytest.raises(ValueError, match="8 tokens .* 4 slots"):
        generate(params, cfg, prompts, max_new_tokens=2, cache_len=4,
                 ring=True)


def test_throughput_probe_reports_the_jax_keys(setup):
    jcfg, cfg, jparams, params = setup
    knobs = dict(batch=2, cache_len=16, steps=3, warmup=1, window=8,
                 ring=True)
    want = jax_decode.batched_throughput_probe(jparams, jcfg, **knobs)
    got = batched_throughput_probe(params, cfg, **knobs)
    assert set(got) == set(want)
    assert got["tokens_per_s"] > 0 and got["ms_per_step"] > 0
    for key in ("batch", "steps", "window", "ring"):
        assert got[key] == want[key]
