"""The moe family's training against the JAX package.

``train_split`` over ``InprocTransport`` (a thread per feature holder) of
reduced deepseek-moe-16b (K = 2 dense towers of one layer, one MoE server
layer with a shared expert), 2 serial steps of 4 x 32 tokens: per-step
losses and router aux losses and the final params within 1e-4
(``tests/test_torch_hybrid_train.py``'s rule), the port's step 0
verified against its serial ``protocol_step`` at 1e-5 in the run, the aux
line printed with its ledger bytes, and each step's Ledger message for
message equal to the JAX package's step schedule at its byte models,
the ``aux_loss`` slot included (4 bytes a microbatch).  The same under
secure aggregation: the masked merge verified in-run, the losses and
aux within 1e-3 (the JAX package's masked-merge tolerance) of the JAX
package's plain run.  Two monolithic ``train`` steps (LM loss plus aux)
of reduced arctic-480b: the losses and every param within 1e-4.  The
launcher's ``--arch deepseek-moe-16b --reduced --transport inproc``
prints the aux line and verifies step 0.

The loader's tokens (one seed in both packages) and the JAX package's
seeded init carried across by ``interop``.  f32.  The JAX package's
init, towers and server run compiled (``tests/jax_compiled.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import get_arch as jax_get_arch
from repro.core import costs as jax_costs
from repro.core import protocol as jax_protocol
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.models import backbone as jax_backbone
from repro.runtime import executor as jax_executor
from repro.train.loop import train as jax_train
from repro.train.loop import train_split as jax_train_split
from repro_torch.configs.base import get_arch
from repro_torch.core import costs
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.launch import train as launch
from repro_torch.train.loop import train, train_split
from jax_compiled import compiled_reference
from test_torch_moe import _one_torch_thread  # noqa: F401

RUN_TOL = dict(rtol=1e-4, atol=1e-4)
MASKED_TOL = dict(rtol=1e-3, atol=1e-3)
BATCH, SEQ, STEPS = 4, 32, 2
DEEPSEEK, ARCTIC = "deepseek-moe-16b", "arctic-480b"


@pytest.fixture(scope="module", autouse=True)
def _compiled_reference():
    with compiled_reference():
        yield


def _configs(arch):
    return jax_get_arch(arch).reduced(), get_arch(arch).reduced()


def _init(jcfg):
    """The JAX ``train`` and ``train_split``'s own init
    (``PRNGKey(seed)``), carried across."""
    init = jax_backbone.init_params(jcfg, jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, init), "cpu")


def _close(got, want, tol):
    got = to_numpy(got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def _messages(ledger):
    return sorted((m.sender, m.receiver, m.tag, m.num_bytes)
                  for m in ledger.messages)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX ``train_split`` of reduced deepseek-moe-16b, with each
    step's aux loss (its ``ExecutionResult.aux``, recorded by wrapping
    ``collect_step``)."""
    jcfg, _ = _configs(DEEPSEEK)
    aux = []
    collect = jax_executor.Executor.collect_step

    def recording(self, *args, **kw):
        res = collect(self, *args, **kw)
        aux.append(float(res.aux))
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_executor.Executor, "collect_step", recording)
        out, metrics, _ = jax_train_split(
            jcfg, JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0), steps=STEPS,
            batch=BATCH, seq=SEQ, transport="inproc", verify_step0=False,
            print_fn=lambda *a: None)
    return out, metrics.losses, aux


def test_train_split_inproc_matches_jax(jax_run):
    """Two serial steps over threads against the JAX ``train_split``:
    losses, aux and params within 1e-4; the aux line; the ledgers equal
    the JAX package's schedule and byte models exactly, the aux slot
    included."""
    jcfg, cfg = _configs(DEEPSEEK)
    jout, jlosses, jaux = jax_run
    lines = []
    out, metrics, _ = train_split(
        cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0), steps=STEPS,
        batch=BATCH, seq=SEQ, transport="inproc", device="cpu",
        params=_init(jcfg), print_fn=lines.append)
    np.testing.assert_allclose(metrics.losses, jlosses, **RUN_TOL)
    assert len(metrics.aux_losses) == STEPS and min(metrics.aux_losses) > 0
    np.testing.assert_allclose(metrics.aux_losses, jaux, **RUN_TOL)
    assert metrics.step0_max_dgrad is not None and \
        metrics.step0_max_dgrad <= 1e-5
    assert any("step-0 verification" in line for line in lines)
    aux_line = [line for line in lines if line.startswith("router aux loss")]
    assert len(aux_line) == 1 and "(4 B in ledger)" in aux_line[0]
    _close(out["towers"], jout["towers"], RUN_TOL)
    _close(out["server"], jout["server"], RUN_TOL)

    sched = jax_protocol.step_schedule(cfg.vertical.num_clients)
    tokens = BATCH * SEQ
    cut = jax_costs.cut_bytes(tokens, cfg.d_model)
    head = jax_costs.head_exchange_bytes(tokens, cfg.vocab_size)
    aux = jax_costs.aux_exchange_bytes(1)
    want = sorted([(m.sender, m.receiver, m.tag, cut)
                   for m in sched.cuts + sched.jacs] +
                  [(m.sender, m.receiver, m.tag, head)
                   for m in (sched.head_out, sched.head_jac)] +
                  [(sched.aux.sender, sched.aux.receiver, sched.aux.tag,
                    aux)])
    assert len(metrics.ledgers) == STEPS
    for ledger in metrics.ledgers:
        assert _messages(ledger) == want
        assert ledger.bytes_with_tag("aux_loss") == \
            costs.aux_exchange_bytes(1) == 4
        assert ledger.total() == costs.cut_bytes(tokens, cfg.d_model) * \
            2 * cfg.vertical.num_clients + 2 * head + aux


def test_train_split_secure_matches_jax(jax_run):
    """Under secure aggregation (the masks the port's own): step 0's
    masked merge verified in-run and role 0's masked sum within the
    bound; losses and aux within the JAX package's masked-merge tolerance
    of its plain run."""
    jcfg, cfg = _configs(DEEPSEEK)
    _, jlosses, jaux = jax_run
    cfg = cfg.with_vertical(dataclasses.replace(cfg.vertical,
                                                secure_aggregation=True))
    lines = []
    _, metrics, _ = train_split(
        cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0), steps=STEPS,
        batch=BATCH, seq=SEQ, transport="inproc", device="cpu",
        params=_init(jcfg), print_fn=lines.append)
    assert any("masked-merge verification" in ln and "OK" in ln
               for ln in lines)
    assert metrics.step0_mask_residue <= metrics.step0_mask_bound
    np.testing.assert_allclose(metrics.losses, jlosses, **MASKED_TOL)
    np.testing.assert_allclose(metrics.aux_losses, jaux, **MASKED_TOL)
    for ledger in metrics.ledgers:
        assert ledger.bytes_with_tag("aux_loss") == 4


def test_train_matches_jax():
    """Two monolithic AdamW steps of reduced arctic-480b (a dense
    residual beside its experts; the loss is the LM loss plus the router
    aux) from the JAX ``train``'s own init: the losses and every param
    within 1e-4."""
    jcfg, cfg = _configs(ARCTIC)
    kw = dict(steps=STEPS, print_fn=lambda *a: None)
    jparams, jmetrics = jax_train(
        jcfg, JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0), **kw)
    got, metrics = train(cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0),
                         device="cpu", params=_init(jcfg), **kw)
    np.testing.assert_allclose(metrics.losses, jmetrics.losses, **RUN_TOL)
    _close(got, jparams, RUN_TOL)


def test_launcher_prints_the_aux_line(capsys):
    """``python -m repro_torch.launch.train --arch deepseek-moe-16b
    --reduced --transport inproc`` trains, verifies step 0 and prints the
    router aux loss with its ledger bytes."""
    assert launch.main(["--arch", DEEPSEEK, "--reduced", "--transport",
                        "inproc", "--steps", "2", "--batch", "2", "--seq",
                        "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "family=moe" in out
    assert "step-0 verification vs protocol_step" in out
    assert "router aux loss" in out and "(4 B in ledger)" in out
