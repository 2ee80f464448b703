"""Monolithic training past 2048 tokens against the JAX package, on the
CPU: reduced smollm-360m (2 layers, d_model 256, 4 heads of 64, K = 2
towers of 1 layer, avg) at 1 x 2304 tokens, where every attention takes
the blocked path (2304**2 > 2048**2).  On the CPU that path is the plain
chunked attention, differentiated by autograd as the JAX package
differentiates its own with ``jax.grad``; on the card it is the flash
kernel forward and the flash backward kernels
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 19).

* the loader's tokens at 2 x 4096 over the full vocabulary, bit for bit;
* ``train_loop.train`` for 2 steps from the JAX package's seeded init and
  tokens: losses at 1e-5;
* the step-0 gradient of ``backbone.train_loss`` against ``jax.grad`` of
  the JAX package's, every leaf at 1e-5 (the JAX package's own step-0
  verification tolerance).

``train_split`` at the same length is in
``tests/test_torch_flash_bwd_split.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.models import backbone as jax_backbone
from repro.train.loop import train as jax_train
from repro_torch.configs.base import get_arch
from repro_torch.data.loader import LMBatchLoader, to_tensor
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import attention as attn
from repro_torch.models import backbone
from repro_torch.train.loop import train
from repro_torch.tree_util import tree_leaves, tree_unflatten

ARCH = "smollm-360m"
BATCH, SEQ, STEPS = 1, 2304, 2
TOL = dict(rtol=1e-5, atol=1e-5)


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
    jcfg, cfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    assert SEQ * SEQ > attn.FLASH_THRESHOLD ** 2
    # the JAX train's own init (eager, PRNGKey(seed)), carried across
    init = jax_backbone.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, init),
                               "cpu")
    return jcfg, cfg, init, params


def test_loader_tokens_past_2048_match_jax():
    """The token stream at the card's training shape, 2 x 4096 over the
    full 49152-token vocabulary: the port draws each Zipf token from a
    cumulative sum taken once, the JAX package through ``rng.choice``
    (which sums the vocabulary at every position); the tokens and labels
    are the same, bit for bit, over two batches."""
    cfg, jcfg = get_arch(ARCH), jax_get_arch(ARCH)
    ours = iter(LMBatchLoader(cfg, 2, 4096, seed=5))
    theirs = iter(JaxLMBatchLoader(jcfg, 2, 4096, seed=5))
    for _ in range(2):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"tokens", "labels"}
        for key in a:
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))


def test_train_past_2048_matches_jax(setup):
    """Two monolithic steps at 1 x 2304 tokens from the same init and
    tokens: per-step losses at 1e-5."""
    jcfg, cfg, _, params = setup
    kw = dict(steps=STEPS, print_fn=lambda *a: None)
    _, jmetrics = jax_train(jcfg, JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0),
                            **kw)
    _, metrics = train(cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0),
                       device="cpu", params=params, **kw)
    assert metrics.steps == list(range(STEPS))
    np.testing.assert_allclose(metrics.losses, jmetrics.losses, **TOL)


def test_step0_gradients_past_2048_match_jax(setup):
    """The first batch's gradient of the LM loss with respect to every
    leaf, through the blocked attention of every layer: autograd against
    ``jax.grad``, at 1e-5."""
    jcfg, cfg, init, params = setup
    batch = next(iter(LMBatchLoader(cfg, BATCH, SEQ, seed=0)))
    want = jax.jit(jax.grad(lambda p, b: jax_backbone.train_loss(
        p, b, jcfg)))(init, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(params)]
    loss = backbone.train_loss(tree_unflatten(params, leaves),
                               {k: to_tensor(v, "cpu")
                                for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    got = jax.tree_util.tree_leaves(to_numpy(tree_unflatten(params, grads)))
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
