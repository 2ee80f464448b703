"""The port's Executor on the paper's MLP program against the JAX package:
the ``(K, B, D)`` cut stack of MLP towers over ``SimTransport`` and
``InprocTransport``, under the ``"fused"`` policy (the merge kernels'
plain versions here, through ``MergePool``) and the ``"neutral"`` one
(``merge_stacked`` with a mask), at microbatches 1 and 4; the protocol's
identity with end-to-end backprop; the ledger against ``epoch_traffic``;
and ``build_mlp_worker`` training over threads along the JAX package's
own loss curve.

Inputs: features and labels made from a seed with numpy; the JAX
package's seeded init carried across by ``interop``.  f32 throughout.
Tolerance 1e-5 for losses and gradients; ledger bytes exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vertical_mlp as jax_configs
from repro.core import protocol as jax_protocol
from repro.core import split_model as jax_split_model
from repro.core import towers as jax_towers
from repro.runtime.executor import Executor as JaxExecutor
from repro.transport import InprocTransport as JaxInprocTransport
from repro.transport import build_mlp_worker as jax_build_mlp_worker
from repro_torch.configs.vertical_mlp import (BANK_MARKETING,
                                              FINANCIAL_PHRASEBANK,
                                              MLPSplitConfig)
from repro_torch.core import costs, protocol, split_model, towers
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.runtime.executor import Executor
from repro_torch.transport import (InprocTransport, SimTransport, TowerWorker,
                                   build_mlp_worker)
from repro_torch.tree_util import tree_map

MERGES = ("max", "avg", "concat", "mul", "sum")
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 16
TRANSPORTS = {"sim": SimTransport, "inproc": InprocTransport}

# the reference's test_inproc_local_updates_train configuration
TINY = MLPSplitConfig(
    name="transport_tiny", input_dim=16, num_classes=2, num_clients=2,
    client_feature_sizes=(8, 8), tower_hidden=(16,), cut_dim=8,
    server_hidden=(16,), merge="avg",
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setup(cfg, seed=0, batch=BATCH):
    """JAX params and both packages' copies of the same features."""
    jparams = jax_split_model.init_split_mlp(jax.random.PRNGKey(seed), cfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.input_dim)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, batch).astype(np.int32)
    slices = split_model.feature_slices(cfg)
    feats = [np.ascontiguousarray(x[:, list(s.indices)]) for s in slices]
    return dict(cfg=cfg, jparams=jparams, params=params, x=x, y=y,
                jfeats=[jnp.asarray(f) for f in feats],
                feats=[torch.from_numpy(f) for f in feats])


def _loss_fns(cfg):
    def jloss(logits, labels):
        return jax_split_model.softmax_xent(logits, labels, cfg.num_classes)

    def loss(logits, labels):
        return split_model.softmax_xent(logits, labels, cfg.num_classes)

    return jloss, loss


def _close(got, want, tol=TOL):
    """``got`` a tree of tensors, ``want`` the same tree of JAX arrays."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b, tol)
    else:
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX package's serial protocol_step per (merge, mask)."""
    cache = {}

    def get(s, merge, mask=None):
        key = (s["cfg"].name, merge, None if mask is None else tuple(mask))
        if key not in cache:
            jloss, _ = _loss_fns(s["cfg"])
            cache[key] = jax_protocol.protocol_step(
                jax_towers.mlp_tower_apply, jax_towers.mlp_tower_apply,
                jloss, s["jparams"]["towers"], s["jparams"]["server"],
                s["jfeats"], jnp.asarray(s["y"]), merge,
                live_mask=None if mask is None else jnp.asarray(mask))
        return cache[key]

    return get


@pytest.fixture(scope="module")
def setups():
    return {cfg.name: {m: _setup(dataclasses.replace(cfg, merge=m))
                       for m in MERGES}
            for cfg in (BANK_MARKETING, FINANCIAL_PHRASEBANK)}


def _run_executor(s, transport_cls, policy, microbatches, mask=None):
    cfg = s["cfg"]
    _, loss = _loss_fns(cfg)
    workers = [TowerWorker(k, towers.mlp_tower_apply, s["params"]["towers"][k])
               for k in range(cfg.num_clients)]
    with transport_cls(workers) as tr:
        executor = Executor(tr, towers.mlp_tower_apply, loss, cfg.merge,
                            mode="pipelined", microbatches=microbatches,
                            drop_policy=policy)
        return executor.run_step(
            s["params"]["server"], torch.from_numpy(s["y"]),
            features=s["feats"],
            merge_mask=None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("dataset", ["bank_marketing",
                                     "financial_phrasebank"])
def test_executor_fused_matches_jax_protocol_step(setups, jax_reference,
                                                  dataset, merge, transport,
                                                  microbatches):
    """The twin of the reference's ``test_inproc_matches_protocol_step``,
    for every merge: the fused policy over either transport reproduces
    the JAX package's serial step, and its ledger carries the same bytes,
    which are ``epoch_traffic``'s for one batch."""
    s = setups[dataset][merge]
    cfg = s["cfg"]
    loss_s, tg_s, sg_s, ledger_s = jax_reference(s, merge)
    res = _run_executor(s, TRANSPORTS[transport], "fused", microbatches)
    _close(res.loss, loss_s)
    _close((res.tower_grads, res.server_grads), (tg_s, sg_s))
    assert res.report.transport == TRANSPORTS[transport].__name__
    assert res.report.staleness == 0
    assert res.ledger.total() == ledger_s.total()
    traffic = costs.epoch_traffic(cfg, BATCH, BATCH)
    assert res.ledger.total() == (traffic["role0"].sent_bytes
                                  + traffic["role0"].received_bytes)
    assert res.ledger.sent_by("role0") == traffic["role0"].sent_bytes
    assert res.ledger.received_by("role0") == traffic["role0"].received_bytes


@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("transport", sorted(TRANSPORTS))
@pytest.mark.parametrize("merge", MERGES)
def test_executor_neutral_with_mask_matches_jax(setups, jax_reference, merge,
                                                transport, microbatches):
    """The neutral policy with one of PhraseBank's four clients masked out
    reproduces the JAX package's masked serial step."""
    s = setups["financial_phrasebank"][merge]
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    loss_s, tg_s, sg_s, _ = jax_reference(s, merge, mask)
    res = _run_executor(s, TRANSPORTS[transport], "neutral", microbatches,
                        mask)
    _close(res.loss, loss_s)
    _close((res.tower_grads, res.server_grads), (tg_s, sg_s))


@pytest.mark.parametrize("merge", MERGES)
def test_protocol_step_and_monolithic_take_mlp_towers(setups, jax_reference,
                                                      merge):
    s = setups["financial_phrasebank"][merge]
    _, loss = _loss_fns(s["cfg"])
    loss_p, tg_p, sg_p, ledger = protocol.protocol_step(
        towers.mlp_tower_apply, towers.mlp_tower_apply, loss,
        s["params"]["towers"], s["params"]["server"], s["feats"],
        torch.from_numpy(s["y"]), merge)
    loss_s, tg_s, sg_s, ledger_s = jax_reference(s, merge)
    _close(loss_p, loss_s)
    _close((tg_p, sg_p), (tg_s, sg_s))
    assert [(m.sender, m.receiver, m.tag, m.num_bytes)
            for m in ledger.messages] == [
        (m.sender, m.receiver, m.tag, m.num_bytes)
        for m in ledger_s.messages]
    protocol.assert_equivalent_to_monolithic(
        towers.mlp_tower_apply, towers.mlp_tower_apply, loss,
        s["params"]["towers"], s["params"]["server"], s["feats"],
        torch.from_numpy(s["y"]), merge)


@pytest.mark.parametrize("policy", ["fused", "neutral"])
def test_max_merge_tie_splits_the_credit(policy):
    """Two clients with the same tower and the same columns tie on every
    cut element: both policies (the fused merge's backward and autograd
    of ``amax``) give each half the credit, as the JAX package does."""
    cfg = dataclasses.replace(BANK_MARKETING, merge="max",
                              client_feature_sizes=(8, 8))
    s = _setup(cfg)
    s["params"]["towers"][1] = s["params"]["towers"][0]
    s["jparams"]["towers"][1] = s["jparams"]["towers"][0]
    s["feats"][1], s["jfeats"][1] = s["feats"][0], s["jfeats"][0]
    jloss, _ = _loss_fns(cfg)
    loss_s, tg_s, sg_s, _ = jax_protocol.protocol_step(
        jax_towers.mlp_tower_apply, jax_towers.mlp_tower_apply, jloss,
        s["jparams"]["towers"], s["jparams"]["server"], s["jfeats"],
        jnp.asarray(s["y"]), "max")
    res = _run_executor(s, SimTransport, policy, 1)
    _close(res.loss, loss_s)
    _close((res.tower_grads, res.server_grads), (tg_s, sg_s))
    _close(res.tower_grads[0], tg_s[1])


def _jax_stream(step, cfg, batch):
    """The reference test's per-step features and labels."""
    ks = jax.random.split(jax.random.PRNGKey(step), 2)
    x = jax.random.normal(ks[0], (batch, cfg.input_dim))
    return x, (x[:, 0] > 0).astype(jnp.int32)


def test_mlp_workers_train_along_the_jax_loss_curve():
    """The twin of the reference's ``test_inproc_local_updates_train``:
    ``build_mlp_worker``s holding a local optimizer behind threads, the
    server updated at role 0.  The JAX package's init and features go to
    the port's workers, and its 30 losses are the reference: the port's
    are held to them at 1e-5 step by step.  The reference's own bar (a
    fall of 0.1 between the first and last five) is not copied: the JAX
    package's loss falls by ~0.06 over these 30 steps."""
    cfg = TINY
    jcfg = jax_configs.MLPSplitConfig(**dataclasses.asdict(cfg))
    batch, steps, lr = 32, 30, 0.2
    jparams = jax_split_model.init_split_mlp(jax.random.PRNGKey(0), jcfg)
    jloss_fn, loss_fn = _loss_fns(cfg)

    jworkers = [jax_build_mlp_worker(k, cfg=jcfg, param_seed=0, data_seed=0,
                                     batch=batch, microbatches=1,
                                     learning_rate=lr)
                for k in range(cfg.num_clients)]
    server, jlosses = jparams["server"], []
    with JaxInprocTransport(jworkers) as tr:
        executor = JaxExecutor(tr, jax_towers.mlp_tower_apply, jloss_fn,
                               cfg.merge, mode="pipelined", microbatches=1)
        for step in range(steps):
            _, y = _jax_stream(step, jcfg, batch)
            res = executor.run_step(server, y, step=step,
                                    collect_grads=False)
            server = jax.tree_util.tree_map(lambda p, g: p - lr * g, server,
                                            res.server_grads)
            jlosses.append(float(res.loss))

    xs = [torch.from_numpy(np.array(_jax_stream(step, jcfg, batch)[0]))
          for step in range(steps)]
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    workers = [build_mlp_worker(k, cfg=cfg, batch=batch, learning_rate=lr,
                                params=params, features=xs.__getitem__,
                                device="cpu")
               for k in range(cfg.num_clients)]
    server, losses = params["server"], []
    with InprocTransport(workers) as tr:
        executor = Executor(tr, towers.mlp_tower_apply, loss_fn, cfg.merge,
                            mode="pipelined", microbatches=1)
        for step in range(steps):
            y = (xs[step][:, 0] > 0).to(torch.int32)
            res = executor.run_step(server, y, step=step,
                                    collect_grads=False)
            server = tree_map(lambda p, g: p - lr * g, server,
                              res.server_grads)
            losses.append(float(res.loss))
    np.testing.assert_allclose(losses, jlosses, **TOL)
    assert sum(losses[-5:]) / 5 < sum(losses[:5]) / 5


@pytest.mark.parametrize("microbatches", [1, 4])
def test_mlp_worker_serves_its_columns_of_the_seeded_stream(microbatches):
    """Default feature source: a per-step N(0, 1) stream from a generator
    seeded with ``data_seed + step``; client k serves its columns of
    microbatch ``mb``'s rows.  The tower is the shared seeded init's."""
    cfg = FINANCIAL_PHRASEBANK
    batch = 16
    params = split_model.init_split_mlp(torch.Generator().manual_seed(3),
                                        cfg, device="cpu")
    mbsz = batch // microbatches
    for k, s in enumerate(split_model.feature_slices(cfg)):
        worker = build_mlp_worker(k, cfg=cfg, param_seed=3, data_seed=7,
                                  batch=batch, microbatches=microbatches,
                                  device="cpu")
        for name, t in worker.params.items():
            assert torch.equal(t, params["towers"][k][name])
        for step in (0, 5):
            x = torch.randn((batch, cfg.input_dim),
                            generator=torch.Generator().manual_seed(7 + step))
            for mb in range(microbatches):
                got = worker.handle({"op": "forward", "step": step,
                                     "mb": mb})["cut"]
                want = towers.mlp_tower_apply(
                    params["towers"][k],
                    x[mb * mbsz:(mb + 1) * mbsz,
                      s.indices[0]:s.indices[-1] + 1])
                torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_mlp_worker_trains_out_of_place():
    """The local SGD writes no tensor it was handed: the params a step's
    forwards ran under stay as they were."""
    cfg = BANK_MARKETING
    worker = build_mlp_worker(0, cfg=cfg, batch=8, learning_rate=0.1,
                              device="cpu")
    before = tree_map(torch.clone, worker.params)
    handed = worker.params
    worker.handle({"op": "forward", "step": 0, "mb": 0})
    worker.handle({"op": "backward", "step": 0, "mb": 0,
                   "jac": torch.ones((8, cfg.cut_dim))})
    done = worker.handle({"op": "finish_step", "step": 0, "microbatches": 1,
                          "collect": True, "expected_jacs": 1})
    assert done["op"] == "step_done"
    for name in before:
        assert torch.equal(handed[name], before[name])
        torch.testing.assert_close(
            worker.params[name], before[name] - 0.1 * done["grad"][name])
    assert not torch.equal(worker.params["w0"], before["w0"])


def test_mlp_worker_refusals():
    cfg = BANK_MARKETING
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mlp_worker(0, cfg=cfg)
    # cut compression is ported: the worker compresses at the source, and
    # an unknown scheme is refused by name, as the JAX package's worker
    worker = build_mlp_worker(0, cfg=cfg, compress="int8", device="cpu")
    assert worker.compress == "int8"
    with pytest.raises(ValueError, match="unknown compression scheme"):
        build_mlp_worker(0, cfg=cfg, compress="fp8", device="cpu")
