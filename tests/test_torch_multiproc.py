"""The port's process transport against the JAX package: one spawned
process per feature holder over TCP loopback
(``repro_torch.transport.MultiprocTransport``).

- The paper MLP's tiny config (the twin of the reference's
  ``test_multiproc_loopback_matches_protocol_and_costs``): the JAX
  package's params and features injected into the spawned workers as
  numpy arrays; loss and gradients within 1e-5 of the JAX
  ``protocol_step``, the per-role Ledger equal to ``costs.epoch_traffic``.
- Reduced smollm-360m (2 layers, d_model 256, K = 2 towers of 1 layer):
  ``train_split(transport="multiproc")`` for 3 steps against the JAX
  package's ``train_split`` at 1e-4 (losses and final params, as
  ``tests/test_torch_train_split.py`` holds the threaded run) and against
  the port's threaded run at 1e-6.
- Reduced split serving over the threaded and the process transports:
  greedy tokens equal the JAX ``SplitLMServer``'s, bytes equal
  ``costs.serve_*``.
- A worker's exception, and a build that fails in the child, surface as a
  ``RuntimeError`` naming the client; no child outlives ``close()``.

Inputs are made from a seed with numpy; f32 throughout.  The children
inherit ``OMP_NUM_THREADS=1`` (one intra-op thread each), set for the
module.
"""
import multiprocessing as mp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core import protocol as jax_protocol
from repro.core import split_model as jax_split_model
from repro.core import towers as jax_towers
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.models import backbone as jax_backbone
from repro.models import split_program as jax_split_program
from repro.serve import SplitLMServer as JaxSplitLMServer
from repro.train.loop import train_split as jax_train_split
from repro.transport import SimTransport as JaxSimTransport
from repro.transport import TowerWorker as JaxTowerWorker
from repro_torch.configs.base import get_arch
from repro_torch.configs.vertical_mlp import MLPSplitConfig
from repro_torch.core import costs, split_model, towers
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import split_program
from repro_torch.runtime.executor import Executor
from repro_torch.serve import SplitLMServer
from repro_torch.train.loop import train_split
from repro_torch.transport import (InprocTransport, MultiprocTransport,
                                   WorkerSpec, build_mlp_worker,
                                   build_split_worker)
from jax_compiled import compiled_reference

TOL = dict(rtol=1e-5, atol=1e-5)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
SAME_TOL = dict(rtol=1e-6, atol=1e-6)
ARCH = "smollm-360m"
BATCH, SEQ = 4, 16
PROMPT_LENS = [8, 5, 12, 7]
NEW_TOKENS = [6, 9, 4, 8]
CACHE_LEN = 32

# the reference's multiproc test configuration
TINY = MLPSplitConfig(
    name="transport_tiny", input_dim=16, num_classes=2, num_clients=2,
    client_feature_sizes=(8, 8), tower_hidden=(16,), cut_dim=8,
    server_hidden=(16,), merge="avg",
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_each():
    """One intra-op thread here and in every spawned child (they read
    ``OMP_NUM_THREADS`` when torch starts): the suite runs in parallel
    worker processes."""
    before, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(before)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _close(got, want, tol):
    """``got`` a tree of tensors, ``want`` the same tree of arrays."""
    got = to_numpy(got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def _no_children_alive():
    assert not mp.active_children()


def test_mlp_loopback_matches_protocol_and_costs():
    """Spawned per-role processes hold only their own tower and feature
    columns (injected as numpy arrays); gradients match the JAX serial
    protocol_step to 1e-5 and the per-role Ledger byte counts equal the
    ``core.costs`` traffic model."""
    cfg, batch, M = TINY, 16, 2
    jparams = jax_split_model.init_split_mlp(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, cfg.input_dim)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, batch).astype(np.int32)
    slices = split_model.feature_slices(cfg)

    def jloss(logits, labels):
        return jax_split_model.softmax_xent(logits, labels, cfg.num_classes)

    def loss(logits, labels):
        return split_model.softmax_xent(logits, labels, cfg.num_classes)

    loss_s, tg_s, sg_s, _ = jax_protocol.protocol_step(
        jax_towers.mlp_tower_apply, jax_towers.mlp_tower_apply, jloss,
        jparams["towers"], jparams["server"],
        [jnp.asarray(x[:, list(s.indices)]) for s in slices],
        jnp.asarray(y), cfg.merge)

    specs = [WorkerSpec(build_mlp_worker,
                        dict(cfg=cfg, params=np_params, batch=batch,
                             microbatches=M, features=x[None],
                             device="cpu"))
             for _ in range(cfg.num_clients)]
    server = params_from_numpy(np_params["server"], "cpu")
    with MultiprocTransport(specs, device="cpu") as tr:
        executor = Executor(tr, towers.mlp_tower_apply, loss, cfg.merge,
                            mode="pipelined", microbatches=M)
        res = executor.run_step(server, torch.from_numpy(y), step=0)
    # close() leaves no child behind
    assert not any(p.is_alive() for p in tr._procs)
    _no_children_alive()

    np.testing.assert_allclose(float(res.loss), float(loss_s), **TOL)
    _close(res.tower_grads, tg_s, TOL)
    _close(res.server_grads, sg_s, TOL)
    assert res.report.transport == "MultiprocTransport"
    assert all(t.device.type == "cpu" for t in
               jax.tree_util.tree_leaves(res.server_grads))

    want = costs.epoch_traffic(cfg, num_samples=batch, batch_size=batch)
    ledger = res.ledger
    assert ledger.sent_by("role0") == want["role0"].sent_bytes
    assert ledger.received_by("role0") == want["role0"].received_bytes
    assert ledger.sent_by("role3") == want["role3"].sent_bytes
    assert ledger.received_by("role3") == want["role3"].received_bytes
    assert ledger.sent_by("role1") == want["role1"].sent_bytes * (
        cfg.num_clients - 1)


@pytest.fixture(scope="module", autouse=True)
def _compiled_reference():
    """The JAX package's init, towers and server compiled
    (``tests/jax_compiled.py``)."""
    with compiled_reference():
        yield


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_get_arch(ARCH).reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return dict(jcfg=jcfg, cfg=get_arch(ARCH).reduced(), jparams=jparams,
                params=params)


def test_train_split_multiproc_matches_jax_and_inproc(lm):
    """Three serial steps over spawned processes: losses and final params
    within 1e-4 of the JAX package's train_split and within 1e-6 of the
    port's threaded run; the step-0 verification holds at 1e-5 and the
    per-step Ledgers equal the threaded run's."""
    jcfg, cfg = lm["jcfg"], lm["cfg"]
    kw = dict(steps=3, batch=BATCH, seq=SEQ, print_fn=lambda *a: None)
    jout, jmetrics, _ = jax_train_split(
        jcfg, JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0), verify_step0=False,
        **kw)
    runs = {}
    for transport in ("inproc", "multiproc"):
        lines = []
        runs[transport] = train_split(
            cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0), device="cpu",
            params=lm["params"], transport=transport,
            **dict(kw, print_fn=lines.append))
        assert any("step-0 verification" in line for line in lines)
    _no_children_alive()
    out, metrics, report = runs["multiproc"]
    assert report.transport == "MultiprocTransport"
    assert metrics.step0_max_dgrad is not None and \
        metrics.step0_max_dgrad <= 1e-5
    np.testing.assert_allclose(metrics.losses, jmetrics.losses, **RUN_TOL)
    _close(out["towers"], jout["towers"], RUN_TOL)
    _close(out["server"], jout["server"], RUN_TOL)
    iout, imetrics, _ = runs["inproc"]
    np.testing.assert_allclose(metrics.losses, imetrics.losses, **SAME_TOL)
    _close(out, to_numpy(iout), SAME_TOL)

    def by_route(ledger):
        return sorted((m.sender, m.receiver, m.tag, m.num_bytes)
                      for m in ledger.messages)

    assert [by_route(a) for a in metrics.ledgers] == \
        [by_route(b) for b in imetrics.ledgers]


@pytest.fixture(scope="module")
def jax_serving(lm):
    """The JAX package's server over its inline transport: tokens once."""
    jcfg, jparams = lm["jcfg"], lm["jparams"]
    program = jax_split_program.get_program(jcfg)
    jtowers, jserver = program.partition(jparams)
    workers = [JaxTowerWorker(k, program.tower_fwd(k), jtowers[k],
                              serve_fns=program.tower_serve_fns(k))
               for k in range(jcfg.vertical.num_clients)]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, lm["cfg"].vocab_size, s).astype(np.int32)
               for s in PROMPT_LENS]
    srv = JaxSplitLMServer(JaxSimTransport(workers), jcfg, jserver,
                           cache_len=CACHE_LEN, max_batch=2)
    for p, n in zip(prompts, NEW_TOKENS):
        srv.submit(p, max_new_tokens=n)
    return prompts, [r.tokens for r in srv.run()]


@pytest.mark.parametrize("transport", ["inproc", "multiproc"])
def test_split_serve_over_transport_matches_jax(lm, jax_serving, transport):
    """``SplitLMServer`` over threads and over spawned processes: greedy
    tokens equal the JAX server's, and every audited byte equals the
    port's ``costs.serve_*`` (the wire moves tensors to the host and
    back; the ledger counts them at role 0, before the wire)."""
    cfg, params = lm["cfg"], lm["params"]
    prompts, jtokens = jax_serving
    K = cfg.vertical.num_clients
    _, server = split_program.get_program(cfg).partition(params)
    if transport == "inproc":
        tr = InprocTransport([build_split_worker(k, cfg=cfg, params=params,
                                                 device="cpu")
                              for k in range(K)])
    else:
        tr = MultiprocTransport(
            [WorkerSpec(build_split_worker,
                        dict(cfg=cfg, params=params, device="cpu"))
             for _ in range(K)], device="cpu")
    with tr:
        srv = SplitLMServer(tr, cfg, server, device="cpu",
                            cache_len=CACHE_LEN, max_batch=2)
        for p, n in zip(prompts, NEW_TOKENS):
            srv.submit(p, max_new_tokens=n)
        tokens = [r.tokens for r in srv.run()]
    _no_children_alive()
    assert tokens == jtokens
    rounds = srv.stats["tokens"] - srv.stats["requests"]
    pf = costs.serve_prefill_bytes(sum(PROMPT_LENS), cfg.d_model, K)
    dc = costs.serve_decode_bytes(cfg.d_model, K, rounds=rounds)
    led = srv.ledger
    assert led.sent_by("role0") == pf["role0_sent"] + dc["role0_sent"]
    assert led.received_by("role0") == (pf["role0_received"]
                                        + dc["role0_received"])
    assert srv.wire_report()["total"] == pf["total"] + dc["total"]


def test_worker_failure_surfaces_and_children_stop():
    """A worker's exception comes back as a RuntimeError naming the
    client and the transport stays usable; a build that fails in the
    child (a card asked for where there is none) is reported in place of
    its hello.  No child outlives close()."""
    spec = WorkerSpec(build_mlp_worker, dict(cfg=TINY, device="cpu"))
    with MultiprocTransport([spec, spec], device="cpu") as tr:
        # a backward with no forward before it: the worker has no features
        tr.submit(1, {"op": "backward", "step": 0, "mb": 0,
                      "jac": torch.zeros(16, TINY.cut_dim)})
        with pytest.raises(RuntimeError, match="client 1 worker failed"):
            tr.next_response(60.0)
        tr.submit(0, {"op": "get_params"})
        k, resp = tr.next_response(60.0)
        assert (k, resp["op"]) == (0, "params")
        assert all(t.device.type == "cpu"
                   for t in jax.tree_util.tree_leaves(resp["params"]))
    assert not any(p.is_alive() for p in tr._procs)
    bad = WorkerSpec(build_mlp_worker, dict(cfg=TINY, device="cuda"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError,
                           match="client 1 worker failed: build failed"):
            MultiprocTransport([spec, bad], device="cpu")
    _no_children_alive()
