"""Reduced zamba2-7b, the hybrid family's whole model, against the JAX
package, at 6 layers and ``every`` 2 (d_model 256, K = 2 Mamba2 towers
of one layer at width 128, 5 server layers: 2 super-blocks and a tail;
``reduced()`` itself, one super-block at ``every`` 1, is trained in
``tests/test_torch_hybrid.py`` and ``tests/test_torch_hybrid_train.py``).
``forward`` logits, ``init_cache``, ``decode_step`` logits and caches,
greedy ``generate`` tokens (over a linear cache, and over a window and a
ring cache), and the refusal of split serving with the JAX package's
reason.

Set-up as ``tests/test_torch_hybrid.py``'s: inputs from numpy seeds, the
JAX package's seeded init carried across by ``interop``, f32.
Tolerances are ``tests/test_torch_ssd.py``'s: logits and caches after
the server 1e-4, tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import backbone as jax_backbone
from repro.models import split_program as jax_split_program
from repro.serve import decode as jax_decode
from repro_torch.interop import to_numpy
from repro_torch.models import backbone, split_program
from repro_torch.serve import generate
from test_torch_hybrid import (LOGIT_TOL, SEQ, _carried, _close,  # noqa: F401
                               _configs, _one_torch_thread, _shapes, _tokens)


@pytest.fixture(scope="module")
def model():
    """Reduced zamba2-7b at 6 layers and ``every`` 2 (5 server layers: 2
    super-blocks and a tail)."""
    jcfg, cfg = _configs(6, 2)
    jparams, params = _carried(jcfg)
    return jcfg, cfg, jparams, params


def test_forward_matches_jax(model):
    """Towers (Mamba2 at d_model / K), the avg merge, the hybrid server,
    the head: logits within 1e-4; ``make_prefill`` the same."""
    jcfg, cfg, jparams, params = model
    toks = _tokens(cfg, (2, SEQ), seed=3)
    want, _ = jax.jit(lambda p, t: jax_backbone.forward(
        p, {"tokens": t}, jcfg))(jparams, jnp.asarray(toks))
    got, aux = backbone.forward(params, {"tokens": torch.from_numpy(toks)},
                                cfg)
    _close(got, want, LOGIT_TOL)
    assert float(aux) == 0.0
    _close(backbone.make_prefill(cfg)(
        params, {"tokens": torch.from_numpy(toks)}), want, LOGIT_TOL)


def test_decode_step_matches_jax(model):
    """Three steps into a prompt, both packages' caches (super-blocks,
    shared attention K/V, tail, towers) and the fourth step's logits
    agree; the positions exactly."""
    jcfg, cfg, jparams, params = model
    toks = _tokens(cfg, (2, 4), seed=4)
    step = jax.jit(lambda p, c, t: jax_backbone.decode_step(p, c, t, jcfg))
    jcache = jax_backbone.init_cache(jcfg, 2, 16)
    cache = backbone.init_cache(cfg, 2, 16, device="cpu")
    assert _shapes(cache) == _shapes(jcache)
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


@pytest.mark.parametrize("knobs", [
    dict(max_new_tokens=6),
    dict(max_new_tokens=8, cache_len=8, window=8, ring=True),
], ids=["linear", "window_ring"])
def test_generate_matches_jax(model, knobs):
    """Greedy tokens: the prompt replayed through ``decode_step``, as the
    JAX package's ``generate`` does for a hybrid; the ring case wraps the
    shared attention's 8 slots (6 prompt + 8 new tokens)."""
    jcfg, cfg, jparams, params = model
    prompts = _tokens(cfg, (2, 6), seed=5)
    want = jax_decode.generate(jparams, jcfg, jnp.asarray(prompts), **knobs)
    got = generate(params, cfg, prompts, **knobs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_serving_refused_as_in_jax():
    """The hybrid towers carry recurrent state whose serving session has no
    shape yet: both packages refuse split serving with one reason; the
    prompt prefill stays dense-only (generate replays the prompt)."""
    jcfg, cfg = _configs()
    prog, jprog = (split_program.get_program(cfg),
                   jax_split_program.get_program(jcfg))
    for fns in ("tower_serve_fns", "server_serve_fns"):
        with pytest.raises(NotImplementedError) as got:
            getattr(prog, fns)(0) if fns == "tower_serve_fns" else \
                getattr(prog, fns)()
        with pytest.raises(NotImplementedError) as want:
            getattr(jprog, fns)(0) if fns == "tower_serve_fns" else \
                getattr(jprog, fns)()
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="replays the prompt"):
        backbone.prefill_tokens({}, backbone.init_cache(cfg, 1, 4,
                                                        device="cpu"),
                                torch.zeros((1, 2), dtype=torch.long), cfg)
