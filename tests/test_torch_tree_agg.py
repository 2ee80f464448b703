"""Aggregation trees on the port's execution path against the JAX package
(the twin of ``tests/test_tree_agg.py``).

- ``step_schedule`` along an ``AggTree`` routes and tags every wire as the
  JAX package's does; the wire-kind and worker-op registries are the JAX
  package's, kind for kind and op for op.
- The tree Executor (``TreeRouter`` over ``SimTransport``, relays
  partial-summing their subtrees, role 0 merging ``min(F, K)`` frames with
  the ``"sum"`` merge and dividing by K for avg) against the JAX
  package's FLAT serial ``protocol_step`` at ``TREE_VERIFY_ATOL``: sum and
  avg, F = 2 and 3, K = 8, M = 2; composed with secure aggregation at the
  masked tolerance 1e-3; the ledger's ``tree_cut[l]`` / ``tree_jac[l]``
  per level equal to ``costs.tree_cut_bytes``.
- Window 2 along the tree follows the star's trajectory, over the inline
  transport and over threads with a lagging leaf; relays accumulate parts
  arriving in any order across adjacent steps in a fixed order.
- The rejections, with the JAX package's words; ``train_split`` with
  ``agg_tree_fanout=2`` at K = 4 verifies step 0 in-run at window 1 and
  2; one multiproc run (K = 3, a relay) matches the flat step.

Inputs from numpy with a seed; the JAX package's params carried across by
``interop``.  f32.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vertical_mlp import MLPSplitConfig as JaxMLPSplitConfig
from repro.core import protocol as jax_protocol
from repro.core import split_model as jax_split_model
from repro.core import towers as jax_towers
from repro.runtime.executor import Executor as JaxExecutor
from repro.runtime.topology import AggTree as JaxAggTree
from repro.transport import SimTransport as JaxSimTransport
from repro.transport import ops as jax_ops
from repro.transport.base import TowerWorker as JaxTowerWorker
from repro_torch.configs.base import get_arch
from repro_torch.configs.vertical_mlp import MLPSplitConfig
from repro_torch.core import compat, costs, protocol, split_model, towers
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.runtime.executor import Executor
from repro_torch.runtime.pipeline import StepPipeline
from repro_torch.runtime.topology import TREE_VERIFY_ATOL, AggTree
from repro_torch.train.loop import train_split
from repro_torch.transport import (InprocTransport, MultiprocTransport,
                                   SimTransport, TowerWorker, TreeRouter,
                                   WorkerSpec, build_mlp_worker, ops)
from repro_torch.tree_util import tree_map

K8 = MLPSplitConfig(
    name="tree_k8", input_dim=16, num_classes=2, num_clients=8,
    client_feature_sizes=(2,) * 8, tower_hidden=(16,), cut_dim=8,
    server_hidden=(16,), merge="sum")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread here and in every spawned child: the suite
    runs in parallel worker processes."""
    before, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(before)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _jcfg(cfg):
    return JaxMLPSplitConfig(**dataclasses.asdict(cfg))


def _mlp(cfg, batch=16, seed=0):
    jparams = jax_split_model.init_split_mlp(jax.random.PRNGKey(seed),
                                             _jcfg(cfg))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.input_dim)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, batch).astype(np.int32)
    feats = [np.ascontiguousarray(x[:, list(s.indices)])
             for s in split_model.feature_slices(cfg)]

    def jloss(logits, labels):
        return jax_split_model.softmax_xent(logits, labels, cfg.num_classes)

    def loss(logits, labels):
        return split_model.softmax_xent(logits, labels, cfg.num_classes)

    return dict(jparams=jparams, x=x, y=y, jloss=jloss, loss=loss,
                params=params_from_numpy(
                    jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
                jfeats=[jnp.asarray(f) for f in feats],
                feats=[torch.from_numpy(f) for f in feats])


def _jax_flat(s, merge):
    return jax_protocol.protocol_step(
        jax_towers.mlp_tower_apply, jax_towers.mlp_tower_apply, s["jloss"],
        s["jparams"]["towers"], s["jparams"]["server"], s["jfeats"],
        jnp.asarray(s["y"]), merge)


def _close(got, want, atol):
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=1e-4)


def _workers(s, K, **kw):
    return [TowerWorker(k, towers.mlp_tower_apply, s["params"]["towers"][k],
                        **kw) for k in range(K)]


@pytest.mark.parametrize("fanout", [2, 3])
def test_tree_schedule_and_registries_match_jax(fanout):
    """Every tree wire's sender, receiver, tag and kind is the JAX
    package's; the wire kinds and worker ops are its registries."""
    mine = protocol.step_schedule(8, tree=AggTree(8, fanout=fanout))
    theirs = jax_protocol.step_schedule(8, tree=JaxAggTree(8, fanout=fanout))
    for a, b in ((mine.cuts, theirs.cuts), (mine.jacs, theirs.jacs),
                 (mine.key_pubs, theirs.key_pubs),
                 (mine.key_bcasts, theirs.key_bcasts)):
        assert [(m.sender, m.receiver, m.tag, m.kind, m.client) for m in a] \
            == [(m.sender, m.receiver, m.tag, m.kind, m.client) for m in b]
    for kw in (dict(secure=True), dict(compress="int8")):
        assert [m.tag for m in protocol.step_schedule(3, **kw).cuts] == \
            [m.tag for m in jax_protocol.step_schedule(3, **kw).cuts]
    assert {k: (v.direction, v.phase, v.cost_model)
            for k, v in protocol.WIRE_KINDS.items()} == \
        {k: (v.direction, v.phase, v.cost_model)
         for k, v in jax_protocol.WIRE_KINDS.items()}
    for name in protocol.WIRE_KINDS.values():
        assert hasattr(costs, name.cost_model)
    assert set(ops.WORKER_OPS) == set(jax_ops.WORKER_OPS)
    for op, spec in ops.WORKER_OPS.items():
        assert spec.handler == jax_ops.WORKER_OPS[op].handler
        assert hasattr(TowerWorker, spec.handler)
    with pytest.raises(ValueError, match="tree covers"):
        protocol.step_schedule(4, tree=AggTree(8, fanout=fanout))


@pytest.mark.parametrize("merge", ["sum", "avg"])
@pytest.mark.parametrize("fanout", [2, 3])
def test_tree_matches_flat_jax_protocol_step(merge, fanout):
    """K = 8 along a fanout-F tree, M = 2, against the JAX package's flat
    serial step at ``TREE_VERIFY_ATOL``; role 0 merged min(F, K) frames
    per microbatch and every tree level's bytes are the byte model's."""
    cfg, M, batch = dataclasses.replace(K8, merge=merge), 2, 16
    s = _mlp(cfg, batch=batch)
    loss_s, tg_s, sg_s, _ = _jax_flat(s, merge)
    tree = AggTree(8, fanout=fanout)
    ex = Executor(SimTransport(_workers(s, 8)), towers.mlp_tower_apply,
                  s["loss"], merge, microbatches=M, agg_tree=tree)
    assert isinstance(ex.transport, TreeRouter)
    try:
        res = ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                          features=s["feats"])
    finally:
        ex.transport.close()
    np.testing.assert_allclose(float(res.loss), float(loss_s),
                               atol=TREE_VERIFY_ATOL)
    _close((res.tower_grads, res.server_grads), (tg_s, sg_s),
           TREE_VERIFY_ATOL)
    want = costs.tree_cut_bytes(tree, (batch // M) * cfg.cut_dim * 4,
                                microbatches=M)
    for lvl in range(tree.depth):
        assert res.ledger.bytes_with_tag(f"tree_cut[{lvl}]") == \
            want["cut_bytes_per_level"][lvl]
        assert res.ledger.bytes_with_tag(f"tree_jac[{lvl}]") == \
            want["jac_bytes_per_level"][lvl]
    assert res.ledger.received_by("role0") - \
        res.ledger.bytes_with_tag("head_jacobian") == \
        want["role0_received"] < want["star_role0_received"]
    assert all(res.ledger.bytes_with_tag(f"cut[{k}]") == 0 for k in range(8))
    assert res.report.cut_bytes_per_client == \
        want["cut_bytes_per_level"][0] // len(tree.top_level)


def test_tree_composes_with_secure_aggregation():
    """Masked cuts partial-sum at the relays and cancel in role 0's
    full-tree sum: the JAX flat plain step at 1e-3, on the tree tags."""
    cfg = dataclasses.replace(K8, merge="avg")
    s = _mlp(cfg)
    loss_s, tg_s, sg_s, _ = _jax_flat(s, "avg")
    ex = Executor(SimTransport(_workers(s, 8)), towers.mlp_tower_apply,
                  s["loss"], "avg", microbatches=2, secure_agg=True,
                  agg_tree=AggTree(8, fanout=2))
    try:
        res = ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                          features=s["feats"])
    finally:
        ex.transport.close()
    np.testing.assert_allclose(float(res.loss), float(loss_s), atol=1e-3)
    _close((res.tower_grads, res.server_grads), (tg_s, sg_s), 1e-3)
    assert res.ledger.bytes_with_tag("tree_cut[0]") > 0
    assert res.ledger.bytes_with_tag("masked_cut[0]") == 0
    assert ex.keyx_ledger.total() == costs.key_exchange_bytes(8)["total"]


def _window_run(s, cfg, tree, transport, delay=0.0, steps=4, lr=0.1):
    """Window 2 with local SGD at the towers and at role 0; the losses."""
    from repro_torch.transport.builders import _sgd

    workers = [TowerWorker(k, towers.mlp_tower_apply,
                           s["params"]["towers"][k], optimizer=_sgd(lr),
                           forward_delay_s=delay if k == cfg.num_clients - 1
                           else 0.0)
               for k in range(cfg.num_clients)]
    ex = Executor(transport(workers), towers.mlp_tower_apply, s["loss"],
                  cfg.merge, microbatches=2, agg_tree=tree)
    sigma, losses = s["params"]["server"], []
    pipe = StepPipeline(ex, window=2)

    def collect():
        nonlocal sigma
        res = pipe.collect(sigma, collect_grads=False)
        sigma = tree_map(lambda p, g: p - lr * g, sigma, res.server_grads)
        losses.append(float(res.loss))

    try:
        for step in range(steps):
            pipe.submit(step, torch.from_numpy(s["y"]), features=s["feats"])
            if pipe.inflight >= 2:
                collect()
        while pipe.inflight:
            collect()
    finally:
        ex.transport.close()
    return losses


def test_tree_window2_matches_star_sim_and_threads():
    """Window 2 (delayed gradients) along the tree follows the star's
    trajectory: inline at K = 8, and over threads at K = 4 with a lagging
    leaf whose parts interleave with the next step's."""
    s = _mlp(K8)
    star = _window_run(s, K8, None, SimTransport)
    treed = _window_run(s, K8, AggTree(8, fanout=2), SimTransport)
    np.testing.assert_allclose(treed, star, atol=TREE_VERIFY_ATOL)
    k4 = dataclasses.replace(K8, num_clients=4, client_feature_sizes=(4,) * 4)
    s4 = _mlp(k4)
    star = _window_run(s4, k4, None, InprocTransport, steps=3)
    treed = _window_run(s4, k4, AggTree(4, fanout=2), InprocTransport,
                        delay=0.05, steps=3)
    np.testing.assert_allclose(treed, star, atol=TREE_VERIFY_ATOL)


def test_relay_accumulates_out_of_order_across_adjacent_steps():
    """Parts of two steps interleave, children before the own cut: each
    step's frame is own + children by id, in that order, bit for bit; a
    duplicate part is refused; a relay's backward carries ``relay_jac``."""
    cfg = dataclasses.replace(K8, num_clients=3,
                              client_feature_sizes=(6, 5, 5))
    s = _mlp(cfg)
    w = TowerWorker(0, towers.mlp_tower_apply, s["params"]["towers"][0])
    assert w.handle({"op": "configure_relay", "children": [1, 2]}) == \
        {"op": "relay_ready", "client": 0}
    with torch.no_grad():
        own = towers.mlp_tower_apply(s["params"]["towers"][0], s["feats"][0])
    f = [torch.randn(own.shape, generator=torch.Generator().manual_seed(i))
         for i in range(4)]

    def part(step, child, frame):
        return w.handle({"op": "aggregate", "step": step, "mb": 0,
                         "child": child, "frame": frame})

    def forward(step):
        return w.handle({"op": "forward", "step": step, "mb": 0,
                         "feats": s["feats"][0]})

    assert part(1, 2, f[0]) is None and part(0, 1, f[1]) is None
    assert forward(1) is None
    done1 = part(1, 1, f[2])
    assert done1["op"] == "tree_cut" and (done1["step"], done1["mb"]) == (1, 0)
    assert torch.equal(done1["cut"], (own + f[2]) + f[0])
    assert forward(0) is None
    assert torch.equal(part(0, 2, f[3])["cut"], (own + f[1]) + f[3])
    part(2, 1, f[0])
    with pytest.raises(ValueError, match="duplicate"):
        part(2, 1, f[0])
    jac = torch.ones_like(own)
    back = w.handle({"op": "backward", "step": 0, "mb": 0, "jac": jac})
    assert back["relay_jac"]["children"] == [1, 2]
    assert torch.equal(back["relay_jac"]["jac"], jac)


def test_unsound_tree_runs_rejected_with_the_jax_words():
    """Executor and worker reject as the JAX package's do; collect refuses
    liveness and a merge mask; train_split refuses before any worker."""
    def jw(k):
        return JaxTowerWorker(k, jax_towers.mlp_tower_apply, None)

    def mw(k):
        return TowerWorker(k, towers.mlp_tower_apply, None)

    cases = [
        ("max", dict()), ("sum", dict(compress="int8")),
        ("avg", dict(mode="nowait")), ("avg", dict(drop_policy="neutral")),
    ]
    for merge, kw in cases:
        with pytest.raises(ValueError) as want:
            JaxExecutor(JaxSimTransport([jw(0), jw(1)]), None, None, merge,
                        agg_tree=JaxAggTree(2, fanout=2), **kw)
        with pytest.raises(ValueError) as got:
            Executor(SimTransport([mw(0), mw(1)]), None, None, merge,
                     agg_tree=AggTree(2, fanout=2), **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="tree covers"):
        Executor(SimTransport([mw(0), mw(1)]), None, None, "sum",
                 agg_tree=AggTree(3, fanout=2))
    with pytest.raises(compat.CompatError, match="cannot compose"):
        TowerWorker(0, None, {}, compress="topk").handle(
            {"op": "configure_relay", "children": [1]})
    cfg = dataclasses.replace(K8, num_clients=3,
                              client_feature_sizes=(6, 5, 5))
    s = _mlp(cfg, batch=8)
    ex = Executor(SimTransport(_workers(s, 3)), towers.mlp_tower_apply,
                  s["loss"], cfg.merge, agg_tree=AggTree(3, fanout=2))
    try:
        ex.submit_step(0, torch.from_numpy(s["y"]), features=s["feats"])
        for kw in (dict(liveness=[[1, 1, 1]]),
                   dict(merge_mask=torch.ones(3))):
            with pytest.raises(ValueError, match="barrier-only"):
                ex.collect_step(s["params"]["server"], **kw)
    finally:
        ex.transport.close()
    lm = get_arch("smollm-360m").reduced()
    comp = lm.with_vertical(dataclasses.replace(lm.vertical,
                                                compression="topk"))
    with pytest.raises(compat.CompatError, match="cannot compose"):
        train_split(comp, LMBatchLoader(comp, 2, 16), steps=1, batch=2,
                    seq=16, agg_tree_fanout=2, device="cpu")


@pytest.mark.parametrize("runtime,mb,window", [("serial", 1, 1),
                                               ("pipelined", 2, 2)])
def test_train_split_tree_verifies_step0(runtime, mb, window):
    """Reduced smollm-360m at K = 4 along a fanout-2 tree (client 0 relays
    for 2 and 3) over threads: step 0 verified in-run against the flat
    serial step at ``TREE_VERIFY_ATOL``; every step's role-0 bytes are the
    two top-level frames."""
    cfg = get_arch("smollm-360m").reduced()
    cfg = cfg.with_vertical(dataclasses.replace(cfg.vertical, num_clients=4))
    lines = []
    _, metrics, report = train_split(
        cfg, LMBatchLoader(cfg, 2, 16), steps=2, batch=2, seq=16,
        runtime=runtime, microbatches=mb, inflight_steps=window,
        agg_tree_fanout=2, device="cpu", print_fn=lines.append)
    assert any("aggregation tree: fanout 2, depth 2, 1 relay(s)" in ln
               for ln in lines)
    assert any("tree-merge verification" in ln and "OK" in ln
               for ln in lines)
    assert metrics.step0_max_dgrad <= TREE_VERIFY_ATOL
    tree = AggTree(4, fanout=2)
    want = costs.tree_cut_bytes(tree, (2 // mb) * 16 * cfg.d_model * 4,
                                microbatches=mb)
    for ledger in metrics.ledgers:
        assert ledger.bytes_with_tag("tree_cut[0]") == want["role0_received"]
        assert ledger.bytes_with_tag("tree_cut[1]") == \
            want["cut_bytes_per_level"][1]
    assert report.staleness == window - 1


def test_multiproc_tree_matches_flat_jax():
    """Three spawned processes, client 0 relaying for client 2 through the
    router's pump thread: the flat JAX step at ``TREE_VERIFY_ATOL``; no
    child outlives ``close``."""
    cfg = dataclasses.replace(K8, num_clients=3,
                              client_feature_sizes=(6, 5, 5))
    batch = 8
    s = _mlp(cfg, batch=batch)
    loss_s, tg_s, sg_s, _ = _jax_flat(s, cfg.merge)
    np_params = jax.tree_util.tree_map(np.asarray, s["jparams"])
    specs = [WorkerSpec(build_mlp_worker, dict(
        cfg=cfg, params=np_params, batch=batch, features=s["x"][None],
        device="cpu")) for _ in range(3)]
    base = MultiprocTransport(specs, device="cpu")
    ex = Executor(base, towers.mlp_tower_apply, s["loss"], cfg.merge,
                  agg_tree=AggTree(3, fanout=2))
    try:
        res = ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                          step=0)
    finally:
        ex.transport.close()
    ex.transport.close()  # idempotent
    assert not any(p.is_alive() for p in base._procs)
    np.testing.assert_allclose(float(res.loss), float(loss_s),
                               atol=TREE_VERIFY_ATOL)
    _close((res.tower_grads, res.server_grads), (tg_s, sg_s),
           TREE_VERIFY_ATOL)
