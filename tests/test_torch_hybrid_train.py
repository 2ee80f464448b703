"""The hybrid family's training against the JAX package.

``train_split`` over ``InprocTransport`` (a thread per feature holder) of
reduced zamba2-7b (one super-block of ``(1, 1, ...)``, no tail:
``server_tail`` None through the Executor and the optimizer), 2 serial
steps of 4 x 64 tokens.  Per-step losses and the final tower and server
params within 1e-4 (``tests/test_torch_ssd_train.py``'s rule after AdamW
steps), the port's step 0 verified against its serial ``protocol_step``
at 1e-5 in the run, and each step's Ledger message for message (sender,
receiver, tag, bytes) equal to the JAX package's step schedule at its
byte models (``repro.core.protocol.step_schedule``, ``repro.core.costs``)
and to the port's own byte models.  One monolithic ``train`` step of the
same model: the loss and every param within 1e-4
(``tests/test_torch_train_mono.py``'s rule).

Set-up as ``tests/test_torch_hybrid.py``'s: the loader's tokens (one
seed in both packages) and the JAX package's seeded init carried across
by ``interop``.  f32.  The JAX package's init, towers and server run
compiled (``tests/jax_compiled.py``: its eager run of these two steps
takes 80 s).
"""
import jax
import numpy as np
import pytest

from repro.core import costs as jax_costs
from repro.core import protocol as jax_protocol
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.models import backbone as jax_backbone
from repro.train.loop import train as jax_train
from repro.train.loop import train_split as jax_train_split
from repro_torch.core import costs
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy
from repro_torch.train.loop import train, train_split
from jax_compiled import compiled_reference
from test_torch_hybrid import (_close, _configs,  # noqa: F401
                               _one_torch_thread)

RUN_TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, SEQ = 4, 64


@pytest.fixture(scope="module", autouse=True)
def _compiled_reference():
    with compiled_reference():
        yield


def _init(jcfg):
    """The JAX ``train`` and ``train_split``'s own init
    (``PRNGKey(seed)``), carried across."""
    init = jax_backbone.init_params(jcfg, jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, init), "cpu")


def _messages(ledger):
    return sorted((m.sender, m.receiver, m.tag, m.num_bytes)
                  for m in ledger.messages)


def test_train_split_inproc_matches_jax():
    """Two serial steps over threads against the JAX ``train_split``:
    losses and params within 1e-4; the ledgers equal the JAX package's
    schedule and byte models exactly."""
    jcfg, cfg = _configs()
    kw = dict(steps=2, batch=BATCH, seq=SEQ, transport="inproc")
    jout, jmetrics, _ = jax_train_split(
        jcfg, JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0), verify_step0=False,
        print_fn=lambda *a: None, **kw)
    lines = []
    out, metrics, _ = train_split(
        cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0), device="cpu",
        params=_init(jcfg), print_fn=lines.append, **kw)
    np.testing.assert_allclose(metrics.losses, jmetrics.losses, **RUN_TOL)
    assert metrics.step0_max_dgrad is not None and \
        metrics.step0_max_dgrad <= 1e-5
    assert any("step-0 verification" in line for line in lines)
    _close(out["towers"], jout["towers"], RUN_TOL)
    _close(out["server"], jout["server"], RUN_TOL)

    # the byte audit: every message of the JAX package's step schedule,
    # at its byte model
    sched = jax_protocol.step_schedule(cfg.vertical.num_clients)
    tokens = BATCH * SEQ
    cut = jax_costs.cut_bytes(tokens, cfg.d_model)
    head = jax_costs.head_exchange_bytes(tokens, cfg.vocab_size)
    want = sorted([(m.sender, m.receiver, m.tag, cut)
                   for m in sched.cuts + sched.jacs] +
                  [(m.sender, m.receiver, m.tag, head)
                   for m in (sched.head_out, sched.head_jac)])
    assert len(metrics.ledgers) == 2
    for ledger in metrics.ledgers:
        assert _messages(ledger) == want
        assert ledger.total() == costs.cut_bytes(tokens, cfg.d_model) * \
            2 * cfg.vertical.num_clients + 2 * head


def test_train_matches_jax():
    """One monolithic AdamW step of reduced zamba2-7b (one super-block, no
    tail: ``server_tail`` None through the optimizer) from the JAX
    ``train``'s own init: the loss and every param within 1e-4
    (``tests/test_torch_train_mono.py``'s rule)."""
    jcfg, cfg = _configs()
    kw = dict(steps=1, print_fn=lambda *a: None)
    jparams, jmetrics = jax_train(
        jcfg, JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0), **kw)
    got, metrics = train(cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0),
                         device="cpu", params=_init(jcfg), **kw)
    assert got["server_tail"] is None and jparams["server_tail"] is None
    np.testing.assert_allclose(metrics.losses, jmetrics.losses, **RUN_TOL)
    _close(got, jparams, RUN_TOL)
