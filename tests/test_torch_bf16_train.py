"""The monolithic ``train(param_dtype=bfloat16)`` against the JAX
package's ``train`` from its bf16 init: reduced smollm-360m (vertical and
centralized) and reduced mamba2-1.3b, three AdamW steps, losses and final
params at the repo's bf16 tolerance, 3e-2 (the probe this test replaces
measured the losses within 1.2e-3 and the params within 1.3e-4).

Inputs: the loader's tokens (one seed in both packages) and the JAX
package's bf16 init (``PRNGKey(0)``) carried across by ``interop``.
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
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.train.loop import train

BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol=BF16_TOL):
    g = jax.tree_util.tree_leaves(to_numpy(got))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a, np.asarray(jnp.asarray(b).astype(jnp.float32)), **tol)


@pytest.mark.parametrize("arch,vertical", [
    ("smollm-360m", True), ("smollm-360m", False), ("mamba2-1.3b", True)],
    ids=["smollm-vertical", "smollm-centralized", "mamba2-vertical"])
def test_train_bf16_matches_jax(arch, vertical):
    """``train(param_dtype=bfloat16)``: three AdamW steps from the JAX
    package's bf16 init against the JAX ``train`` from the same init; the
    params stay bf16."""
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    if not vertical:
        jcfg, cfg = jcfg.with_vertical(None), cfg.with_vertical(None)
    kw = dict(steps=3, print_fn=lambda *a: None)
    jparams, jmetrics = jax_train(jcfg, JaxLMBatchLoader(jcfg, 4, 32, seed=0),
                                  param_dtype=jnp.bfloat16, **kw)
    init = jax_backbone.init_params(jcfg, jax.random.PRNGKey(0),
                                    jnp.bfloat16)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, init),
                               "cpu")
    got, metrics = train(cfg, LMBatchLoader(cfg, 4, 32, seed=0),
                         device="cpu", params=params,
                         param_dtype=torch.bfloat16, **kw)
    # every leaf keeps the JAX package's dtype (bf16, and the ssm's f32
    # decay and skip parameters)
    assert [str(t.dtype).removeprefix("torch.")
            for t in jax.tree_util.tree_leaves(got)] == \
        [str(a.dtype) for a in jax.tree_util.tree_leaves(jparams)]
    np.testing.assert_allclose(metrics.losses, jmetrics.losses, **BF16_TOL)
    _close(got, jparams)
