"""Split training past 2048 tokens against the JAX package, on the CPU:
reduced smollm-360m (K = 2 towers of 1 layer, avg, a 1-layer server
trunk of 2 layers in all) at 1 x 2304 tokens over the threaded
transport, where every attention (the towers' and the server's) takes
the blocked path.  On the CPU that path is the plain chunked attention
under autograd; on the card, the flash kernel forward and the flash
backward kernels (``chip_smoke.py`` phase 19 (c)).

* ``train_split`` for 2 steps from the JAX package's params and tokens:
  losses at 1e-5, the in-run step-0 verification against the port's
  serial ``protocol_step`` at 1e-5;
* the serial ``protocol_step`` of the first batch: the loss and every
  tower and server gradient against the JAX package's, at 1e-5 (the JAX
  package's own step-0 verification tolerance).

The JAX package's side runs compiled (``tests/jax_compiled.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.models import backbone as jax_backbone
from repro.models import split_program as jax_split_program
from repro.train.loop import train_split as jax_train_split
from repro_torch.configs.base import get_arch
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import split_program
from repro_torch.train.loop import train_split

from jax_compiled import compiled_reference

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
def reference():
    """The JAX package's 2-step ``train_split`` and its serial
    ``protocol_step`` on the first batch, compiled, from its seeded init;
    and that init carried across."""
    jcfg = jax_get_arch(ARCH).reduced()
    with compiled_reference():
        init = jax_backbone.init_params(jcfg, jax.random.PRNGKey(0))
        _, jmetrics, _ = jax_train_split(
            jcfg, JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0), steps=STEPS,
            batch=BATCH, seq=SEQ, verify_step0=False,
            print_fn=lambda *a: None)
        jb = {k: jnp.asarray(v) for k, v in next(iter(
            JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0))).items()}
        prog = jax_split_program.get_program(jcfg)
        tow, serv = prog.partition(init)
        step0 = prog.protocol_step(tow, serv, prog.features(jb),
                                   prog.batch_ctx(jb))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, init),
                               "cpu")
    return dict(losses=jmetrics.losses, step0=step0, params=params)


def test_train_split_past_2048_matches_jax(reference):
    """Two split steps at 1 x 2304 tokens over the threaded transport:
    losses at 1e-5; the port verifies its step 0 in the run."""
    cfg = get_arch(ARCH).reduced()
    lines = []
    _, metrics, _ = train_split(
        cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0), steps=STEPS,
        batch=BATCH, seq=SEQ, transport="inproc", device="cpu",
        params=reference["params"], print_fn=lines.append)
    assert metrics.steps == list(range(STEPS))
    np.testing.assert_allclose(metrics.losses, reference["losses"], **TOL)
    assert metrics.step0_max_dgrad is not None and \
        metrics.step0_max_dgrad <= 1e-5
    assert any("step-0 verification" in line for line in lines)


def test_protocol_step_past_2048_matches_jax(reference):
    """The serial protocol step of the first batch: loss, tower gradients
    and server gradients against the JAX package's at 1e-5."""
    cfg = get_arch(ARCH).reduced()
    batch = next(iter(LMBatchLoader(cfg, BATCH, SEQ, seed=0)))
    prog = split_program.get_program(cfg)
    tow, serv = prog.partition(reference["params"])
    loss, tg, sg, _ = prog.protocol_step(
        tow, serv, prog.features(batch, "cpu"), prog.batch_ctx(batch, "cpu"))
    jloss, jtg, jsg, _ = reference["step0"]
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    got = jax.tree_util.tree_leaves(to_numpy((tg, sg)))
    want = jax.tree_util.tree_leaves((jtg, jsg))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)
