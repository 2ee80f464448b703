"""The port's training step against the JAX package — the split
program, ``protocol_step`` and the ``Executor`` over both transports — on
reduced smollm-360m (2 layers, d_model 256, K = 2 towers of 1 layer,
vocab 512) with the JAX package's params carried across by ``interop``.
``train_split`` and the loader are held to the JAX package in
``tests/test_torch_train_split.py``.

Inputs: the loader's tokens (numpy, the same seed in both packages) and
the JAX package's seeded init.  f32 throughout.  Tolerance: 1e-5 for one
step's loss and gradients (the two packages sum in different orders,
nothing else differs).  Ledgers are compared message for message.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core import compat as jax_compat
from repro.models import backbone as jax_backbone
from repro.models import split_program as jax_split_program
from repro.runtime.executor import Executor as JaxExecutor
from repro.transport.base import SimTransport as JaxSimTransport
from repro.transport.base import TowerWorker as JaxTowerWorker
from repro_torch.configs.base import get_arch
from repro_torch.core import compat, costs, protocol
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import backbone, split_program
from repro_torch.runtime.executor import Executor
from repro_torch.train.loop import train_split
from repro_torch.transport import (InprocTransport, SimTransport, TowerWorker,
                                   build_split_worker)

ARCH = "smollm-360m"
BATCH, SEQ = 4, 16
STEP_TOL = dict(rtol=1e-5, atol=1e-5)


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
    cfg = get_arch(ARCH).reduced()
    jparams = jax_backbone.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    jprog = jax_split_program.get_program(jcfg)
    prog = split_program.get_program(cfg)
    batch = LMBatchLoader(cfg, BATCH, SEQ, seed=0).next_batch()
    # the M = 2 runs take twice the batch, so their microbatches have the
    # shapes of the M = 1 runs and reuse the JAX package's compiled ops
    batch2 = LMBatchLoader(cfg, 2 * BATCH, SEQ, seed=1).next_batch()
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jprog=jprog, prog=prog, batch=batch, batch2=batch2,
                jparts=jprog.partition(jparams), parts=prog.partition(params))


def _close(got, want, tol=STEP_TOL):
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


def _messages(ledger):
    return sorted((m.sender, m.receiver, m.tag, m.num_bytes)
                  for m in ledger.messages)


def test_program_training_fns_match_jax(setup):
    """tower_fwd per client, server_fwd on the merged cut, loss_fn."""
    jprog, prog, batch = setup["jprog"], setup["prog"], setup["batch"]
    (jtowers, jserver), (towers, server) = setup["jparts"], setup["parts"]
    jtok, tok = jnp.asarray(batch["tokens"]), torch.from_numpy(
        batch["tokens"])
    jcuts, cuts = [], []
    for k in range(prog.num_clients):
        jcuts.append(jprog.tower_fwd(k)(jtowers[k], jtok))
        cuts.append(prog.tower_fwd(k)(towers[k], tok))
        assert tuple(cuts[k].shape) == (BATCH, SEQ, setup["cfg"].d_model)
        _close(cuts[k], jcuts[k])
    merged = torch.stack(cuts).mean(0)
    jlogits = jprog.server_fwd(jserver, jnp.stack(jcuts).mean(0))
    logits = prog.server_fwd(server, merged)
    _close(logits, jlogits)
    labels = torch.from_numpy(batch["labels"])
    _close(prog.loss_fn(logits, labels),
           jprog.loss_fn(jlogits, jnp.asarray(batch["labels"])))


def test_split_lm_helpers_wrap_the_program(setup):
    """backbone's split helpers are the program's partition and training
    callables, as in the JAX package."""
    cfg, batch = setup["cfg"], setup["batch"]
    towers, server = backbone.split_lm_params(cfg, setup["params"])
    jtowers, jserver = jax_backbone.split_lm_params(setup["jcfg"],
                                                    setup["jparams"])
    _close((towers, server), (jtowers, jserver))
    tower_fwd, server_fwd, loss_fn = backbone.make_split_lm_fns(cfg)
    jtower_fwd, _, _ = jax_backbone.make_split_lm_fns(setup["jcfg"])
    cut = tower_fwd(towers[0], torch.from_numpy(batch["tokens"]))
    _close(cut, jtower_fwd(jtowers[0], jnp.asarray(batch["tokens"])))
    program_cls = type(setup["prog"])
    assert server_fwd.__func__ is program_cls.server_fwd
    assert loss_fn.__func__ is program_cls.loss_fn


def test_partition_copies_the_embedding_columns(setup):
    """Towers own copies: neither the table nor the (K, ...) stack is
    shared with the server tree or between clients."""
    towers, server = setup["parts"]
    table = server["embed"]["table"]
    for tp in towers:
        assert tp["embed_slice"].untyped_storage().data_ptr() != \
            table.untyped_storage().data_ptr()
        assert tp["proj_in"].untyped_storage().data_ptr() != \
            setup["params"]["towers"]["proj_in"].untyped_storage().data_ptr()


def test_protocol_step_matches_jax(setup):
    """Loss, tower and server grads at 1e-5; the ledger message for
    message, and its bytes equal to the byte models."""
    jprog, prog, batch, cfg = (setup["jprog"], setup["prog"], setup["batch"],
                               setup["cfg"])
    (jtowers, jserver), (towers, server) = setup["jparts"], setup["parts"]
    jloss, jtg, jsg, jledger = jprog.protocol_step(
        jtowers, jserver, jprog.features(batch), jprog.batch_ctx(batch))
    loss, tg, sg, ledger = prog.protocol_step(
        towers, server, prog.features(batch, "cpu"),
        prog.batch_ctx(batch, "cpu"))
    _close(loss, jloss)
    _close(tg, jtg)
    _close(sg, jsg)
    assert _messages(ledger) == _messages(jledger)
    K, tokens = cfg.vertical.num_clients, BATCH * SEQ
    for k in range(K):
        assert ledger.bytes_with_tag(f"cut[{k}]") == \
            ledger.bytes_with_tag(f"jac[{k}]") == \
            costs.cut_bytes(tokens, cfg.d_model)
    head = costs.head_exchange_bytes(tokens, cfg.vocab_size)
    assert ledger.bytes_with_tag("head_output") == head
    assert ledger.bytes_with_tag("head_jacobian") == head
    assert ledger.bytes_with_tag("aux_loss") == 0  # the dense family has none
    assert ledger.total() == 2 * K * costs.cut_bytes(
        tokens, cfg.d_model) + 2 * head


def test_protocol_equals_monolithic_backprop(setup):
    """The paper's §3 identity on the port: the protocol's gradients are
    end-to-end backprop through the merged graph."""
    prog, batch = setup["prog"], setup["batch"]
    towers, server = setup["parts"]
    protocol.assert_equivalent_to_monolithic(
        prog.tower_fwds, prog.server_fwd, prog.loss_fn, towers, server,
        prog.features(batch, "cpu"), prog.batch_ctx(batch, "cpu"),
        prog.merge)


@pytest.fixture(scope="module")
def jax_exec_results(setup):
    """The JAX Executor, fused policy, over its SimTransport — once per
    (mode, microbatches)."""
    jprog = setup["jprog"]
    jtowers, jserver = setup["jparts"]
    out = {}
    for mode, M in (("serial", 1), ("pipelined", 2)):
        batch = setup["batch" if M == 1 else "batch2"]
        workers = [JaxTowerWorker(k, jprog.tower_fwd(k), jtowers[k])
                   for k in range(jprog.num_clients)]
        ex = JaxExecutor(JaxSimTransport(workers), jprog.server_fwd,
                         jprog.loss_fn, jprog.merge, mode=mode,
                         microbatches=M, **jprog.executor_kwargs)
        out[(mode, M)] = ex.run_step(jserver, jprog.batch_ctx(batch),
                                     features=jprog.features(batch))
    return out


@pytest.mark.parametrize("mode,M", [("serial", 1), ("pipelined", 2)])
@pytest.mark.parametrize("transport_cls", [SimTransport, InprocTransport])
def test_executor_fused_matches_jax(setup, jax_exec_results, transport_cls,
                                    mode, M):
    """The port's Executor (fused policy: ``fast_merge`` through MergePool)
    over the inline and the threaded transport, M = 1 and pipelined
    M = 2: loss and grads at 1e-5, the ledger message for message."""
    prog, batch = setup["prog"], setup["batch" if M == 1 else "batch2"]
    towers, server = setup["parts"]
    want = jax_exec_results[(mode, M)]
    workers = [TowerWorker(k, prog.tower_fwd(k), towers[k])
               for k in range(prog.num_clients)]
    tr = transport_cls(workers)
    try:
        ex = Executor(tr, prog.server_fwd, prog.loss_fn, prog.merge,
                      mode=mode, microbatches=M, **prog.executor_kwargs)
        assert ex.drop_policy == "fused"
        res = ex.run_step(server, prog.batch_ctx(batch, "cpu"),
                          features=prog.features(batch, "cpu"))
    finally:
        tr.close()
    _close(res.loss, want.loss)
    _close(res.tower_grads, want.tower_grads)
    _close(res.server_grads, want.server_grads)
    assert _messages(res.ledger) == _messages(want.ledger)
    assert res.report.cut_bytes_per_client == \
        want.report.cut_bytes_per_client
    assert res.report.collective_bytes_per_client == \
        want.report.collective_bytes_per_client
    assert res.report.microbatches == M and res.report.staleness == 0
    assert res.loss.requires_grad is False


def test_workers_regenerate_features_from_seed(setup):
    """Workers built by ``build_split_worker`` own their token stream
    (regenerated from the loader seed): no features cross the transport,
    and the step equals the serial reference."""
    prog, batch, cfg = setup["prog"], setup["batch"], setup["cfg"]
    towers, server = setup["parts"]
    loss_s, tg_s, sg_s, _ = prog.protocol_step(
        towers, server, prog.features(batch, "cpu"),
        prog.batch_ctx(batch, "cpu"))
    workers = [build_split_worker(k, cfg=cfg, seed=0, batch=BATCH, seq=SEQ,
                                  params=setup["params"], device="cpu")
               for k in range(prog.num_clients)]
    with InprocTransport(workers) as tr:
        ex = Executor(tr, prog.server_fwd, prog.loss_fn, prog.merge,
                      mode="serial")
        res = ex.run_step(server, prog.batch_ctx(batch, "cpu"), step=0)
    _close(res.loss, to_numpy(loss_s))
    _close((res.tower_grads, res.server_grads), to_numpy((tg_s, sg_s)))


def test_compat_rules_are_the_jax_rules():
    """The port's matrix is the JAX package's, restricted to the layers
    the port enforces: same keys, features, reasons and order."""
    mine = [(r.key, r.features, r.layers, r.reason) for r in compat.RULES]
    theirs = []
    for rule in jax_compat.RULES:
        layers = tuple(x for x in rule.layers if x in compat.LAYER_MODULES)
        if layers:
            theirs.append((rule.key, rule.features, layers, rule.reason))
    assert mine == theirs
    assert set(compat.LAYER_MODULES) <= set(jax_compat.LAYER_MODULES)


def test_unported_features_raise(setup):
    """The wire overlays are ported and construct as the JAX package's do;
    unsound compositions reject through the compat matrix with its words,
    and what the port does not carry yet (a program ``merge_fn``) is
    refused by name — never silently ignored."""
    from repro.core.protocol import step_schedule as jax_step_schedule
    from repro.runtime.topology import AggTree as JaxAggTree
    from repro_torch.runtime.topology import AggTree

    prog, cfg = setup["prog"], setup["cfg"]
    towers, _ = setup["parts"]
    tr = SimTransport([TowerWorker(k, prog.tower_fwd(k), towers[k])
                       for k in range(prog.num_clients)])
    args = (tr, prog.server_fwd, prog.loss_fn)
    with pytest.raises(compat.CompatError, match="additively homomorphic"):
        Executor(*args, "max", agg_tree=object())
    with pytest.raises(compat.CompatError, match="cannot compose"):
        Executor(*args, "avg", secure_agg=True, compress="int8")
    for kw in (dict(secure_agg=True), dict(compress="topk"),
               dict(agg_tree=AggTree(prog.num_clients, fanout=2))):
        ex = Executor(*args, "avg", **kw)
        assert ex._schedule.cuts[0].kind == {
            "secure_agg": "masked_cut", "compress": "compressed_cut",
            "agg_tree": "tree_cut"}[next(iter(kw))]
    with pytest.raises(NotImplementedError, match="not ported"):
        Executor(*args, "avg", merge_fn=lambda c, m: c)
    # the schedules tag the overlays' wires as the JAX package's do
    sched = protocol.step_schedule(2, compress="int8")
    jsched = jax_step_schedule(2, compress="int8")
    assert [(m.tag, m.kind) for m in sched.cuts + sched.jacs] == \
        [(m.tag, m.kind) for m in jsched.cuts + jsched.jacs]
    jtree = jax_step_schedule(2, tree=JaxAggTree(2, fanout=2))
    mtree = protocol.step_schedule(2, tree=AggTree(2, fanout=2))
    assert [(m.sender, m.receiver, m.tag) for m in mtree.cuts] == \
        [(m.sender, m.receiver, m.tag) for m in jtree.cuts]
    loader = LMBatchLoader(cfg, BATCH, SEQ)
    # the tree runs over processes (one step, verified at step 0); an
    # unknown transport is refused by name
    _, metrics, _ = train_split(
        cfg, loader, steps=1, batch=BATCH, seq=SEQ, agg_tree_fanout=2,
        transport="multiproc", device="cpu", params=setup["params"],
        print_fn=lambda *a: None)
    assert metrics.step0_max_dgrad is not None and len(metrics.losses) == 1
    with pytest.raises(ValueError, match="unknown split transport 'tcp'"):
        train_split(cfg, loader, steps=1, batch=BATCH, seq=SEQ,
                    transport="tcp", device="cpu", params=setup["params"])
    with pytest.raises(compat.CompatError, match="barrier execution"):
        train_split(cfg, loader, steps=1, runtime="nowait",
                    agg_tree_fanout=2, device="cpu")


def test_worker_failure_surfaces_and_threads_stop(setup):
    """A worker's exception comes back to role 0 as a RuntimeError naming
    the client, and close() stops every worker thread."""
    prog = setup["prog"]
    towers, _ = setup["parts"]
    before = threading.active_count()
    tr = InprocTransport([TowerWorker(k, prog.tower_fwd(k), towers[k])
                          for k in range(prog.num_clients)])
    try:
        tr.submit(1, {"op": "forward", "step": 0, "mb": 0})  # no feats
        with pytest.raises(RuntimeError, match="client 1 worker failed"):
            tr.next_response(30.0)
    finally:
        tr.close()
    assert threading.active_count() == before
