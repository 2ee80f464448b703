"""The other dense configs against the JAX package: qk-norm attention
(qwen3-32b) and stablelm-3b.

- ``attention_apply`` with qk-norm params, over the dense branch (16
  tokens) and the chunked one (2304 tokens, past the 2048 threshold; the
  card runs the flash kernel there), and ``decode_attention_apply`` over
  a partly filled cache: outputs and the new K/V within 1e-5 (K past 2048
  positions within 5e-4).
- Reduced qwen3-32b (2 layers, d_model 256, 4 / 4 heads, K = 2 towers of
  one layer): ``forward`` logits, ``prefill_tokens`` then
  ``decode_step`` logits step by step within 1e-5, greedy ``generate``
  tokens equal, and ``SplitLMServer``'s tokens equal to ``generate``'s;
  a bf16 tree's forward and greedy tokens at the repo's bf16 rules.
- Reduced stablelm-3b with its full head dim (80): ``forward`` logits and
  greedy tokens.

The JAX package normalises q and k at eps 1e-6 in the full-sequence
attention and at ``rmsnorm``'s default 1e-5 in the one-token decode (a
reference quirk the port copies).  With unit-scale inputs the per-head
variance of q and k is ~1 and the two eps differ by ~5e-6 relative,
below any tolerance here; so the inputs of the attention tests are drawn
at 1e-3 scale, and the reduced qwen3's ``wq`` and ``wk`` (server and
towers, both packages) are scaled by 1e-3: q and k then have a variance
near 1e-6 and the eps move the logits by far more than 1e-5.

Inputs come from ``numpy.random.default_rng`` seeds; params from the JAX
package's seeded init (or numpy draws), carried across by ``interop``.
Tolerances are ``tests/test_torch_dense_generate.py``'s: f32 logits 1e-5
absolute; bf16 logits 3e-2 and greedy tokens equal up to a step whose
top-2 logit gap is 6e-2 or less.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.models import attention as jax_attn
from repro.models import backbone as jax_backbone
from repro.serve import decode as jax_decode
from repro_torch.configs.base import get_arch
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import attention, backbone, split_program
from repro_torch.serve import SplitLMServer, generate
from repro_torch.transport import SimTransport, build_split_worker

TOL = dict(rtol=0, atol=1e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
ROPE_TOL = dict(rtol=0, atol=5e-4)  # RoPE'd past 2048 positions
GAP = 6e-2
QK_SCALE = 1e-3  # wq / wk scale: per-head variance of q and k near 1e-6
# (d_model, heads, kv heads, head dim) of the attention tests
D, H, KV, HD = 32, 4, 2, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _attn_params(seed):
    """qk-norm attention params drawn with numpy: fan-in scaled
    projections and norm scales in [0.5, 1.5] (not ones, so that a
    missing scale shows)."""
    rng = np.random.default_rng(seed)

    def dense(d_in, d_out):
        return (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(
            np.float32)

    return {"wq": dense(D, H * HD), "wk": dense(D, KV * HD),
            "wv": dense(D, KV * HD), "wo": dense(H * HD, D),
            "q_norm": {"scale": rng.uniform(0.5, 1.5, HD).astype(np.float32)},
            "k_norm": {"scale": rng.uniform(0.5, 1.5, HD).astype(np.float32)}}


def test_init_attention_carries_qk_norm():
    """``qk_norm`` adds ``q_norm`` and ``k_norm`` of width ``head_dim``,
    ones, stacked with the layer's leading axes, as the JAX package's."""
    gen = torch.Generator().manual_seed(0)
    p = attention.init_attention(gen, D, H, KV, HD, qk_norm=True, lead=(3,))
    want = jax.vmap(lambda k: jax_attn.init_attention(
        k, D, H, KV, HD, qk_norm=True))(jax.random.split(
            jax.random.PRNGKey(0), 3))
    assert jax.tree_util.tree_structure(to_numpy(p)) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(p)),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape
    np.testing.assert_array_equal(to_numpy(p["q_norm"]["scale"]), 1.0)
    assert "q_norm" not in attention.init_attention(gen, D, H, KV, HD)


@pytest.mark.parametrize("S", [16, 2304], ids=["dense", "chunked"])
def test_qk_norm_attention_apply_matches_jax(S):
    """q and k normalised per head at eps 1e-6 before RoPE: the output and
    V within 1e-5, K within 1e-5 over the dense branch and 5e-4 past 2048
    positions, where the JAX package's compiled RoPE parts from its eager
    RoPE (``tests/test_torch_dense_generate.py``'s rule for RoPE'd
    caches; here 3.2e-5 at most)."""
    params = _attn_params(seed=0)
    x = (np.random.default_rng(1).standard_normal((2, S, D)) *
         1e-3).astype(np.float32)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=HD, rope_theta=1e6)
    want, (jk, jv) = jax.jit(lambda p, x: jax_attn.attention_apply(
        p, x, **kw))(jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(x))
    got, (k, v) = attention.attention_apply(
        params_from_numpy(params, "cpu"), torch.from_numpy(x), **kw)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_numpy(k), np.asarray(jk),
                               **(TOL if S <= 2048 else ROPE_TOL))
    np.testing.assert_allclose(to_numpy(v), np.asarray(jv), **TOL)


def test_qk_norm_decode_attention_matches_jax():
    """One cached token at position 5 of an 8-slot cache (slots 0-4
    written, the rest unwritten): q and k normalised at 1e-5; the output
    and the cache's new row within 1e-5."""
    params = _attn_params(seed=2)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 1, D)) * 1e-3).astype(np.float32)
    ck = rng.standard_normal((2, 8, KV, HD)).astype(np.float32)
    cv = rng.standard_normal((2, 8, KV, HD)).astype(np.float32)
    ck[:, 5:] = cv[:, 5:] = 0.0
    kpos = np.array([0, 1, 2, 3, 4, -1, -1, -1], np.int32)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=HD, rope_theta=1e6)
    want, jk, _, jpos, _ = jax_attn.decode_attention_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(ck), jnp.asarray(cv), jnp.int32(5),
        kv_positions=jnp.asarray(kpos), **kw)
    got, k, _, pos, _ = attention.decode_attention_apply(
        params_from_numpy(params, "cpu"), torch.from_numpy(x),
        torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
        torch.full((2,), 5), kv_positions=torch.from_numpy(
            np.stack([kpos] * 2)).long(), **kw)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_numpy(k), np.asarray(jk), **TOL)
    np.testing.assert_array_equal(to_numpy(pos)[0], np.asarray(jpos))


def _scale_qk(tree):
    """``wq`` and ``wk`` of every attention in a param tree times
    QK_SCALE."""
    if isinstance(tree, dict):
        return {k: (v * QK_SCALE if k in ("wq", "wk") else _scale_qk(v))
                for k, v in tree.items()}
    return tree


def _carried(arch, dtype=jnp.float32, **overrides):
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced(), **overrides)
    cfg = dataclasses.replace(get_arch(arch).reduced(), **overrides)
    jparams = jax.jit(jax_backbone.init_params, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), dtype)
    if cfg.qk_norm:
        jparams = _scale_qk(jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def qwen3():
    return _carried("qwen3-32b")


def test_qwen3_forward_matches_jax(qwen3):
    """qk-norm params in every block (server and towers), q_norm / k_norm
    of the head dim; ``forward`` logits within 1e-5."""
    jcfg, cfg, jparams, params = qwen3
    assert cfg.qk_norm and tuple(params["server"]["attn"]["q_norm"][
        "scale"].shape) == (1, cfg.resolved_head_dim())
    assert "k_norm" in params["towers"]["blocks"]["attn"]
    tokens = _tokens(cfg, (2, 24), seed=0)
    want, _ = jax.jit(lambda p, t: jax_backbone.forward(
        p, {"tokens": t}, jcfg))(jparams, jnp.asarray(tokens))
    got, _ = backbone.forward(params, {"tokens": torch.from_numpy(tokens)},
                              cfg)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)


def test_qwen3_prefill_and_decode_match_jax(qwen3):
    """``prefill_tokens`` (eps 1e-6) over an 8-token prompt, then five
    ``decode_step``s (eps 1e-5) along the JAX package's greedy tokens:
    the logits at every step and the final caches within 1e-5."""
    jcfg, cfg, jparams, params = qwen3
    prompts = _tokens(cfg, (2, 8), seed=1)
    jlogits, jcache = jax.jit(lambda p, c, t: jax_backbone.prefill_tokens(
        p, c, t, jcfg))(jparams, jax_backbone.init_cache(jcfg, 2, 16),
                        jnp.asarray(prompts))
    logits, cache = backbone.prefill_tokens(
        params, backbone.init_cache(cfg, 2, 16, device="cpu"),
        torch.from_numpy(prompts), cfg)
    step = jax.jit(lambda p, c, t: jax_backbone.decode_step(p, c, t, jcfg))
    for t in range(5):
        np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits),
                                   **TOL, err_msg=f"step {t}")
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        jlogits, jcache = step(jparams, jcache, jnp.asarray(tok))
        logits, cache = backbone.decode_step(params, cache,
                                             torch.from_numpy(tok), cfg)
    np.testing.assert_allclose(to_numpy(logits), np.asarray(jlogits), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_numpy(cache[key]),
                                   np.asarray(jcache[key]), **TOL)
        np.testing.assert_allclose(to_numpy(cache["tower"][key]),
                                   np.asarray(jcache["tower"][key]), **TOL)


def test_qwen3_generate_matches_jax_and_split_server(qwen3):
    """Greedy tokens of ``generate`` equal the JAX package's, and the
    port's ``SplitLMServer`` (K = 2 tower workers, 2 slots) gives the same
    tokens request by request."""
    jcfg, cfg, jparams, params = qwen3
    prompts = _tokens(cfg, (2, 6), seed=2)
    want = jax_decode.generate(jparams, jcfg, jnp.asarray(prompts),
                               max_new_tokens=8)
    got = generate(params, cfg, prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, server = split_program.get_program(cfg).partition(params)
    workers = [build_split_worker(k, cfg=cfg, params=params, device="cpu")
               for k in range(cfg.vertical.num_clients)]
    srv = SplitLMServer(SimTransport(workers), cfg, server, device="cpu",
                        cache_len=16, max_batch=2)
    for p in prompts:
        srv.submit(p, max_new_tokens=8)
    assert [r.tokens for r in srv.run()] == got.tolist()


def test_qwen3_bf16_matches_jax():
    """A bf16 tree: ``forward`` logits within 3e-2 of the JAX package's,
    and the first greedy token of ``generate`` (prefill over the first 8
    tokens) equal to the JAX package's unless the top-2 gap there is
    6e-2 or less."""
    jcfg, cfg, jparams, params = _carried("qwen3-32b", jnp.bfloat16)
    assert params["server"]["attn"]["q_norm"]["scale"].dtype == \
        torch.bfloat16
    tokens = _tokens(cfg, (2, 16), seed=3)
    want, _ = jax.jit(lambda p, t: jax_backbone.forward(
        p, {"tokens": t}, jcfg))(jparams, jnp.asarray(tokens))
    got, _ = backbone.forward(params, {"tokens": torch.from_numpy(tokens)},
                              cfg)
    ref = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(to_numpy(got), ref, **BF16_TOL)
    new = 4
    jtoks = np.asarray(jax_decode.generate(
        jparams, jcfg, jnp.asarray(tokens[:, :8]), max_new_tokens=new))
    toks = generate(params, cfg, tokens[:, :8], max_new_tokens=new).numpy()
    # the first generated token follows the logits at prompt position 7
    top2 = np.sort(ref[:, 7], -1)[:, -2:]
    for row in range(2):
        assert toks[row, 0] == jtoks[row, 0] or \
            top2[row, 1] - top2[row, 0] <= GAP


def test_stablelm_head_dim_80_matches_jax():
    """Reduced stablelm-3b at its full head dim 80 (4 heads of 80 on a
    256-wide model; ``reduced()`` resets the head dim, so both configs
    put it back): ``forward`` logits within 1e-5 and greedy tokens
    equal."""
    jcfg, cfg, jparams, params = _carried("stablelm-3b", head_dim=80)
    assert cfg.resolved_head_dim() == 80 and not cfg.qk_norm
    tokens = _tokens(cfg, (2, 20), seed=4)
    want, _ = jax.jit(lambda p, t: jax_backbone.forward(
        p, {"tokens": t}, jcfg))(jparams, jnp.asarray(tokens))
    got, _ = backbone.forward(params, {"tokens": torch.from_numpy(tokens)},
                              cfg)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)
    want = jax_decode.generate(jparams, jcfg, jnp.asarray(tokens[:, :6]),
                               max_new_tokens=6)
    got = generate(params, cfg, tokens[:, :6], max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
