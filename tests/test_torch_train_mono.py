"""The port's monolithic training and centralized LM against the JAX
package.

- ``train_loop.train`` (AdamW under the warmup cosine schedule, weight
  decay 0.1, clipping) of reduced smollm-360m, vertical (2 layers, d_model
  256, K = 2 towers of 1 layer, avg) and centralized (``vertical=None``),
  and of reduced mamba2-1.3b (the plain SSD chunk scan), 3 steps from the
  JAX package's seeded init: losses and final params within 1e-4 of the
  JAX ``train`` (AdamW divides by ``sqrt(v)``, which magnifies rounding
  in the smallest gradients), as ``tests/test_torch_train_split.py``
  holds split training.
- The centralized ``forward`` within 1e-5 and greedy ``generate`` tokens
  equal to the JAX package's.
- ``param_count`` equal to the JAX package's, exactly, at full width,
  reduced, at each ``--scale`` preset and centralized.
- The ``constant`` and ``inverse_sqrt`` schedules equal at counts 0-50.

Inputs: the loader's tokens (numpy, one seed in both packages) and the
JAX package's seeded init carried across by ``interop``.  f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.launch.train import scale_config as jax_scale_config
from repro.models import backbone as jax_backbone
from repro.optim import schedules as jax_schedules
from repro.serve import decode as jax_decode
from repro.train.loop import train as jax_train
from repro_torch.configs.base import get_arch
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.launch.train import scale_config
from repro_torch.models import backbone
from repro_torch.optim import schedules
from repro_torch.serve import generate
from repro_torch.train.loop import train

RUN_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=0, atol=1e-5)
BATCH, SEQ, STEPS = 4, 32, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(arch: str, vertical: bool):
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    if not vertical:
        jcfg, cfg = jcfg.with_vertical(None), cfg.with_vertical(None)
    return jcfg, cfg


def _close(got, want, tol):
    got = to_numpy(got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


@pytest.mark.parametrize("arch,vertical", [
    ("smollm-360m", True), ("smollm-360m", False), ("mamba2-1.3b", True)],
    ids=["smollm-vertical", "smollm-centralized", "mamba2-vertical"])
def test_train_matches_jax(arch, vertical):
    """Three monolithic steps from the same init and tokens: per-step
    losses and the final params at 1e-4."""
    jcfg, cfg = _configs(arch, vertical)
    # the launcher's defaults (lr 3e-4, 20 warmup steps), as
    # tests/test_torch_train_split.py runs split training
    kw = dict(steps=STEPS, print_fn=lambda *a: None)
    jparams, jmetrics = jax_train(
        jcfg, JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0), **kw)
    # the JAX train's own init (eager, PRNGKey(seed)), carried across
    init = jax_backbone.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, init),
                               "cpu")
    got, metrics = train(cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0),
                         device="cpu", params=params, **kw)
    assert ("towers" in got) == vertical
    assert metrics.steps == list(range(STEPS))
    np.testing.assert_allclose(metrics.losses, jmetrics.losses, **RUN_TOL)
    _close(got, jparams, RUN_TOL)
    moved = max(float(np.max(np.abs(a - np.asarray(b)))) for a, b in zip(
        jax.tree_util.tree_leaves(to_numpy(got)),
        jax.tree_util.tree_leaves(init)))
    assert moved > 1e-5  # three updates of up to ~lr each


@pytest.fixture(scope="module")
def centralized():
    jcfg, cfg = _configs("smollm-360m", vertical=False)
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jcfg, cfg, jparams, params


def test_centralized_forward_and_generate_match_jax(centralized):
    """``vertical=None``: no towers in the tree or the caches; logits at
    1e-5 and greedy tokens (the prefill, then the decode steps) equal."""
    jcfg, cfg, jparams, params = centralized
    assert "towers" not in params
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jax_backbone.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                   jcfg)
    got, aux = backbone.forward(params, {"tokens": torch.from_numpy(tokens)},
                                cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0
    assert "tower" not in backbone.init_cache(cfg, 2, 16, device="cpu")
    prompts = tokens[:, :6]
    want = jax_decode.generate(jparams, jcfg, jnp.asarray(prompts),
                               max_new_tokens=8)
    got = generate(params, cfg, prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


FULL_COUNTS = {"smollm-360m": 346_816_704, "mamba2-1.3b": 1_414_019_584,
               "starcoder2-3b": 4_125_023_232, "stablelm-3b": 2_684_520_960,
               "qwen3-32b": 32_229_460_480, "zamba2-7b": 6_650_983_376}


@pytest.mark.parametrize("arch", sorted(FULL_COUNTS))
def test_param_count_matches_jax(arch):
    """From shapes alone (the init on the ``meta`` device), exactly the
    JAX package's count: full width, reduced, each ``--scale`` preset,
    each of them centralized too."""
    assert backbone.param_count(get_arch(arch)) == FULL_COUNTS[arch]
    cases = [(get_arch(arch), jax_get_arch(arch)),
             (get_arch(arch).reduced(), jax_get_arch(arch).reduced())]
    cases += [(scale_config(get_arch(arch), s),
               jax_scale_config(jax_get_arch(arch), s))
              for s in ("100m", "25m", "10m")]
    for cfg, jcfg in list(cases):
        cases.append((cfg.with_vertical(None), jcfg.with_vertical(None)))
    for cfg, jcfg in cases:
        assert backbone.param_count(cfg) == jax_backbone.param_count(jcfg), \
            cfg
    # the meta init allocates nothing and its count is the real tree's
    cfg = dataclasses.replace(get_arch(arch).reduced(), vocab_size=64)
    real = backbone.init_params(cfg, device="cpu")
    assert backbone.param_count(cfg) == sum(
        t.numel() for t in jax.tree_util.tree_leaves(real))


def test_schedules_match_jax():
    """``constant`` and ``inverse_sqrt`` (with and without warmup), f32 at
    every count 0-50."""
    counts = np.arange(51, dtype=np.int32)
    pairs = [(schedules.constant(3e-4), jax_schedules.constant(3e-4)),
             (schedules.inverse_sqrt(1e-3, 10),
              jax_schedules.inverse_sqrt(1e-3, 10)),
             (schedules.inverse_sqrt(1e-3, 0),
              jax_schedules.inverse_sqrt(1e-3, 0))]
    for mine, theirs in pairs:
        for c in counts:
            got = mine(torch.tensor(c))
            want = np.asarray(theirs(jnp.asarray(c)))
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got.numpy(), want)
