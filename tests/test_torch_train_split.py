"""The port's ``train_split`` at window 1 and its token loader against
the JAX package, on reduced smollm-360m (2 layers, d_model 256, K = 2
towers of 1 layer, vocab 512) with the JAX package's params carried
across by ``interop``.  ``tests/test_torch_train_window.py`` runs
:func:`run_against_jax` at window 2 (a file each, so that each runs in
under a minute: the JAX package compiles op by op).

Inputs: the loader's tokens (numpy, the same seed in both packages) and
the JAX package's seeded init, which the JAX ``train_split`` runs itself
and the port's is handed.  f32 throughout.  Tolerance: 1e-4 for losses
and params after three optimizer steps (AdamW divides by ``sqrt(v)``,
which magnifies rounding in the smallest gradients); the port's own
step-0 verification holds at 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.models import backbone as jax_backbone
from repro.train.loop import train_split as jax_train_split
from repro_torch.configs.base import get_arch
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.train.loop import train_split

ARCH = "smollm-360m"
BATCH, SEQ = 4, 16
RUN_TOL = dict(rtol=1e-4, atol=1e-4)


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
    # eager, as the JAX train_split and its workers run the init
    jparams = jax_backbone.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return dict(jcfg=jcfg, cfg=get_arch(ARCH).reduced(), jparams=jparams,
                params=params)


def _close(got, want, tol):
    """``got`` a tree of tensors, ``want`` the same tree of JAX arrays."""
    got = to_numpy(got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def test_loader_tokens_match_jax():
    """Same seed, the same tokens and labels, bit for bit."""
    for arch_cfg, seed in ((get_arch(ARCH).reduced(), 0), (get_arch(ARCH), 3)):
        jcfg = jax_get_arch(ARCH).reduced() if arch_cfg.vocab_size < 1000 \
            else jax_get_arch(ARCH)
        ours = iter(LMBatchLoader(arch_cfg, 3, 24, seed=seed))
        theirs = iter(JaxLMBatchLoader(jcfg, 3, 24, seed=seed))
        for _ in range(3):
            a, b = next(ours), next(theirs)
            assert set(a) == set(b) == {"tokens", "labels"}
            for key in a:
                assert a[key].dtype == np.int32
                np.testing.assert_array_equal(a[key], np.asarray(b[key]))


def test_train_split_matches_jax(setup):
    """Three steps of split training over the threaded transport at window
    1: per-step losses and the final tower and server params at 1e-4.
    The port verifies its step 0 against its protocol_step in the run."""
    run_against_jax(setup, window=1)


def run_against_jax(setup, window: int) -> None:
    """Three steps of the JAX ``train_split`` and of the port's, at
    ``window``, from the same params and tokens."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    kw = dict(steps=3, batch=BATCH, seq=SEQ, inflight_steps=window,
              print_fn=lambda *a: None)
    jout, jmetrics, jreport = jax_train_split(
        jcfg, JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0), verify_step0=False,
        **kw)
    lines = []
    out, metrics, report = train_split(
        cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0), device="cpu",
        params=setup["params"], **dict(kw, print_fn=lines.append))
    np.testing.assert_allclose(metrics.losses, jmetrics.losses, **RUN_TOL)
    assert metrics.steps == [0, 1, 2]
    assert metrics.step0_max_dgrad is not None and \
        metrics.step0_max_dgrad <= 1e-5
    assert any("step-0 verification" in line for line in lines)
    assert report.staleness == jreport.staleness == window - 1
    _close(out["towers"], jout["towers"], RUN_TOL)
    _close(out["server"], jout["server"], RUN_TOL)
    # the injected params are read, never written
    _close(setup["params"], jax.tree_util.tree_map(np.asarray,
                                                   setup["jparams"]),
           dict(rtol=0, atol=0))
