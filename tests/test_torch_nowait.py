"""No-wait split training in the port against the JAX package: EMA
imputation (``core.straggler``), the Executor's ``"impute"`` policy and
``"nowait"`` mode, ``engine.pipelined_step`` over the simulated clock,
and ``train_split(runtime="nowait")``.

Inputs: numpy draws from a seed, and the JAX package's seeded init and
drop masks carried across (torch cannot reproduce ``jax.random``).  f32
throughout.  Tolerances: 1e-6 for the imputation itself, 1e-5 for a
step's loss, gradients and EMA state (the packages sum in different
orders), liveness matrices equal.

The simulated clock makes no-wait deterministic, so parity with the JAX
package goes through ``pipelined_step`` (``liveness=``).  Wall-clock
no-wait is nondeterministic by design: those tests assert behaviour (who
misses, finite losses, zero gradient for a client that missed every
microbatch), not values.  Their straggler sleeps 1.0 s per forward and
the static window is 0.15 s, so its second cut lands 2 s in, far past
the window under any load of the test run.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vertical_mlp as jax_configs
from repro.core import dropping as jax_dropping
from repro.core import split_model as jax_split_model
from repro.core import straggler as jax_straggler
from repro.core import towers as jax_towers
from repro.optim import SGD as JaxSGD
from repro.runtime import engine as jax_engine
from repro.runtime.links import LinkModel as JaxLinkModel
from repro_torch.configs.base import get_arch
from repro_torch.configs.vertical_mlp import FINANCIAL_PHRASEBANK, MLPSplitConfig
from repro_torch.core import compat, protocol, split_model, straggler, towers
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.optim import SGD
from repro_torch.runtime import deadline as deadline_lib
from repro_torch.runtime import engine
from repro_torch.runtime.deadline import AdaptiveDeadline
from repro_torch.runtime.executor import Executor
from repro_torch.runtime.links import LinkModel
from repro_torch.train.loop import train_split
from repro_torch.transport import InprocTransport, SimTransport, TowerWorker

TOL = dict(rtol=1e-5, atol=1e-5)
IMPUTE_TOL = dict(rtol=1e-6, atol=1e-6)
MERGES = ("avg", "max", "sum", "mul", "concat")
# a healthy majority of 2 around one straggler (the JAX package's TINY3)
TINY3 = dict(name="nowait_tiny3", input_dim=12, num_classes=2,
             num_clients=3, client_feature_sizes=(4, 4, 4),
             tower_hidden=(16,), cut_dim=8, server_hidden=(16,), merge="avg")
STRAGGLER_DELAY_S = 1.0  # per straggler forward, wall-clock tests


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **tol)


def _close_tree(got, want, tol=TOL):
    g, w = jax.tree_util.tree_leaves(to_numpy(got)), \
        jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def _configs(fields):
    return MLPSplitConfig(**fields), jax_configs.MLPSplitConfig(**fields)


def _setup(cfg, jcfg, seed=0, batch=16):
    """JAX params carried across, and both packages' copies of the same
    per-client features and labels."""
    jparams = jax_split_model.init_split_mlp(jax.random.PRNGKey(seed), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.input_dim)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, batch).astype(np.int32)
    feats = [np.ascontiguousarray(x[:, list(s.indices)])
             for s in split_model.feature_slices(cfg)]
    return dict(jparams=jparams, params=params, x=x, y=y,
                jfeats=[jnp.asarray(f) for f in feats],
                feats=[torch.from_numpy(f) for f in feats])


def _loss_fns(num_classes):
    def loss(logits, labels):
        return split_model.softmax_xent(logits, labels, num_classes)

    def jloss(logits, labels):
        return jax_split_model.softmax_xent(logits, labels, num_classes)

    return loss, jloss


def _states(K, D, rng, initialized):
    ema = rng.standard_normal((K, D)).astype(np.float32)
    init = np.asarray(initialized, np.float32)
    return ({"ema": torch.from_numpy(ema), "initialized":
             torch.from_numpy(init)},
            {"ema": jnp.asarray(ema), "initialized": jnp.asarray(init)})


# ---------------------------------------------------------------------------
# the imputation itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 8, 16), (4, 3, 5, 16), (2, 1, 7)])
@pytest.mark.parametrize("live", ["all", "one", "most"])
def test_impute_stack_matches_jax(shape, live):
    K, D = shape[0], shape[-1]
    rng = np.random.default_rng(sum(shape))
    mask = np.ones(K, np.float32)
    if live != "all":
        mask[:K - 1 if live == "one" else 1] = 0.0
    mask = mask[::-1].copy()
    cuts = rng.standard_normal(shape).astype(np.float32)
    for initialized in ([0.0] * K, [1.0] * K, [1.0, 0.0] * (K // 2)):
        state, jstate = _states(K, D, rng, initialized)
        got, gs = straggler.impute_stack(torch.from_numpy(cuts),
                                         torch.from_numpy(mask), state,
                                         decay=0.9)
        want, ws = jax_straggler.impute_stack(jnp.asarray(cuts),
                                              jnp.asarray(mask), jstate,
                                              decay=0.9)
        _close(got, want, IMPUTE_TOL)
        _close_tree(gs, ws, IMPUTE_TOL)
        assert got.shape == shape


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("shape", [(4, 8, 16), (4, 2, 3, 16)])
def test_impute_and_merge_matches_jax(merge, shape):
    K, D = shape[0], shape[-1]
    rng = np.random.default_rng(7)
    state, jstate = _states(K, D, rng, [0.0] * K)
    for mask in ([1.0] * K, [0.0, 1.0, 1.0, 1.0], [1.0, 0.0, 0.0, 1.0]):
        cuts = rng.standard_normal(shape).astype(np.float32)
        mask = np.asarray(mask, np.float32)
        got, state = straggler.impute_and_merge(
            torch.from_numpy(cuts), torch.from_numpy(mask), state, merge)
        want, jstate = jax_straggler.impute_and_merge(
            jnp.asarray(cuts), jnp.asarray(mask), jstate, merge)
        _close(got, want, IMPUTE_TOL)
        _close_tree(state, jstate, IMPUTE_TOL)


def test_imputed_seats_get_zero_gradient():
    """Inside an autograd graph a filled seat gets zero gradient and a live
    seat the merge's own backward: the imputation does not leak gradient
    into the EMA or out of it."""
    rng = np.random.default_rng(3)
    cuts = torch.from_numpy(rng.standard_normal((4, 5, 6)).astype(
        np.float32)).requires_grad_(True)
    state, _ = _states(4, 6, rng, [1.0] * 4)
    live = torch.tensor([1.0, 0.0, 1.0, 1.0])
    imputed, new = straggler.impute_stack(cuts, live, state)
    g = torch.randn((5, 6), generator=torch.Generator().manual_seed(0))
    (grad,) = torch.autograd.grad((imputed.mean(0) * g).sum(), cuts)
    assert float(grad[1].abs().max()) == 0.0
    np.testing.assert_allclose(grad[[0, 2, 3]].numpy(),
                               (g / 4).expand(3, 5, 6).numpy(), rtol=1e-6)
    assert straggler.detach_state(new)["ema"].grad_fn is None


def test_init_ema_state():
    cfg, jcfg = _configs(TINY3)
    state = straggler.init_ema_state(cfg, device="cpu")
    _close_tree(state, jax_straggler.init_ema_state(jcfg), IMPUTE_TOL)
    assert state["ema"].device.type == "cpu"
    if not torch.cuda.is_available():
        # the card by default: without one, only an explicit CPU runs
        with pytest.raises(RuntimeError, match="device='cpu'"):
            straggler.init_ema_state(cfg)


def test_imputing_train_step_matches_jax():
    """Five SGD steps on PhraseBank with 2 of 4 clients dropped per step:
    the JAX package's masks (drawn from its keys) injected, the losses,
    the EMA state and the final params within 1e-5."""
    cfg, jcfg = FINANCIAL_PHRASEBANK, jax_configs.FINANCIAL_PHRASEBANK
    s = _setup(cfg, jcfg, batch=32)
    rng = np.random.default_rng(5)
    jstep = jax_straggler.make_imputing_train_step(jcfg, JaxSGD(0.1),
                                                   num_drop=2)
    step = straggler.make_imputing_train_step(cfg, SGD(0.1), num_drop=2)
    jp, p = s["jparams"], s["params"]
    jo, o = JaxSGD(0.1).init(jp), SGD(0.1).init(p)
    jema = jax_straggler.init_ema_state(jcfg)
    ema = straggler.init_ema_state(cfg, device="cpu")
    key = jax.random.PRNGKey(11)
    for i in range(5):
        x = rng.standard_normal((32, cfg.input_dim)).astype(np.float32)
        y = rng.integers(0, cfg.num_classes, 32).astype(np.int32)
        key, sub = jax.random.split(key)
        mask = np.array(jax_dropping.sample_live_mask(
            sub, cfg.num_clients, 2))
        assert mask.sum() == 2
        jp, jo, jema, jloss = jstep(jp, jo, jema, sub, jnp.asarray(x),
                                    jnp.asarray(y))
        p, o, ema, loss = step(p, o, ema, None, torch.from_numpy(x),
                               torch.from_numpy(y),
                               live_mask=torch.from_numpy(mask))
        _close(loss, jloss)
        _close_tree(ema, jema)
        assert ema["ema"].grad_fn is None
    _close_tree(p, jp)


def test_imputing_train_step_draws_its_masks():
    """With a generator and no mask the step draws exactly ``num_drop``
    drops per step through ``dropping.sample_live_mask`` and trains."""
    cfg = FINANCIAL_PHRASEBANK
    params = split_model.init_split_mlp(None, cfg, device="cpu")
    step = straggler.make_imputing_train_step(cfg, SGD(0.1), num_drop=1)
    opt = SGD(0.1).init(params)
    ema = straggler.init_ema_state(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((16, cfg.input_dim), generator=gen)
    y = torch.randint(0, cfg.num_classes, (16,), generator=gen)
    for _ in range(3):
        params, opt, ema, loss = step(params, opt, ema, gen, x, y)
        assert torch.isfinite(loss)
    assert int(ema["initialized"].sum()) >= 3
    with pytest.raises(ValueError, match="generator or a live_mask"):
        step(params, opt, ema, None, x, y)


# ---------------------------------------------------------------------------
# pipelined_step: the simulated clock, then the Executor over SimTransport
# ---------------------------------------------------------------------------

def _pipelined(s, cfg, loss, merge, M, mode, link, ema_state, **kw):
    return engine.pipelined_step(
        towers.mlp_tower_apply, towers.mlp_tower_apply, loss,
        s["params"]["towers"], s["params"]["server"], s["feats"],
        torch.from_numpy(s["y"]), merge, microbatches=M, mode=mode,
        link=link, ema_state=ema_state, device="cpu", **kw)


def _jax_pipelined(s, jloss, merge, M, mode, jlink, ema_state, **kw):
    return jax_engine.pipelined_step(
        jax_towers.mlp_tower_apply, jax_towers.mlp_tower_apply, jloss,
        s["jparams"]["towers"], s["jparams"]["server"], s["jfeats"],
        jnp.asarray(s["y"]), merge, microbatches=M, mode=mode, link=jlink,
        ema_state=ema_state, **kw)


@pytest.mark.parametrize("merge", ["avg", "max", "concat"])
def test_nowait_pipelined_step_matches_jax(merge):
    """Four steps of SGD with client 1 a 20x straggler on the simulated
    clock: identical live matrices, and loss, tower and server grads and
    EMA state within 1e-5; the straggler's tower gets zero gradient."""
    cfg, jcfg = _configs(dict(TINY3, merge=merge))
    s = _setup(cfg, jcfg, batch=32)
    loss, jloss = _loss_fns(cfg.num_classes)
    M, lr = 4, 0.2
    plan, jplan = engine.plan_step(cfg, 32, M), \
        jax_engine.plan_step(jcfg, 32, M)
    link = LinkModel.uniform(3).with_straggler(1, slowdown=20.0)
    jlink = JaxLinkModel.uniform(3).with_straggler(1, slowdown=20.0)
    ema = jema = None
    for step in range(4):
        out = _pipelined(s, cfg, loss, merge, M, "nowait", link, ema,
                         plan=plan)
        jout = _jax_pipelined(s, jloss, merge, M, "nowait", jlink, jema,
                              plan=jplan)
        loss_v, tg, sg, ledger, report, ema = out
        jloss_v, jtg, jsg, jledger, jreport, jema = jout
        assert report.live == jreport.live
        assert report.misses_per_client == [0, M, 0]
        assert dataclasses.asdict(report) == dataclasses.asdict(jreport)
        _close(loss_v, jloss_v)
        _close_tree((tg, sg), (jtg, jsg))
        _close_tree(ema, jema)
        for leaf in tg[1].values():
            assert float(leaf.abs().max()) == 0.0
        # jacobians only to live clients: none to the straggler
        assert ledger.bytes_with_tag("jac[1]") == 0
        assert ledger.bytes_with_tag("cut[1]") == \
            jledger.bytes_with_tag("cut[1]") > 0
        sgd = lambda p, g: p - lr * g  # noqa: E731
        s["params"] = {"towers": [jax.tree_util.tree_map(sgd, p, g) for p, g
                                  in zip(s["params"]["towers"], tg)],
                       "server": jax.tree_util.tree_map(
                           sgd, s["params"]["server"], sg)}
        s["jparams"] = {"towers": [jax.tree_util.tree_map(sgd, p, g) for p, g
                                   in zip(s["jparams"]["towers"], jtg)],
                        "server": jax.tree_util.tree_map(
                            sgd, s["jparams"]["server"], jsg)}


@pytest.mark.parametrize("merge", ["avg", "mul"])
@pytest.mark.parametrize("M", [1, 4])
def test_pipelined_step_equals_protocol_step(merge, M):
    """Staleness 0: the port's pipelined_step equals its protocol_step and
    the JAX package's pipelined_step, with no miss."""
    cfg, jcfg = _configs(dict(TINY3, merge=merge))
    s = _setup(cfg, jcfg)
    loss, jloss = _loss_fns(cfg.num_classes)
    link = LinkModel.uniform(3)
    got = _pipelined(s, cfg, loss, merge, M, "pipelined", link, None,
                     plan=engine.plan_step(cfg, 16, M))
    ref = protocol.protocol_step(
        towers.mlp_tower_apply, towers.mlp_tower_apply, loss,
        s["params"]["towers"], s["params"]["server"], s["feats"],
        torch.from_numpy(s["y"]), merge)
    want = _jax_pipelined(s, jloss, merge, M, "pipelined",
                          JaxLinkModel.uniform(3), None,
                          plan=jax_engine.plan_step(jcfg, 16, M))
    assert got[4].total_misses == 0 and got[5] is None
    _close(got[0], want[0])
    _close_tree(got[1:3], want[1:3])
    for a, b in zip(jax.tree_util.tree_leaves((got[1], got[2])),
                    jax.tree_util.tree_leaves((ref[1], ref[2]))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_pipelined_step_default_plan_and_device():
    """Without a plan the step probes the cut width, as the JAX package's
    does; params on another device than the step's are refused."""
    cfg, jcfg = _configs(TINY3)
    s = _setup(cfg, jcfg)
    loss, jloss = _loss_fns(cfg.num_classes)
    got = _pipelined(s, cfg, loss, "avg", 2, "nowait", None, None)
    want = _jax_pipelined(s, jloss, "avg", 2, "nowait", None, None)
    assert dataclasses.asdict(got[4]) == dataclasses.asdict(want[4])
    _close(got[0], want[0])
    _close_tree(got[5], want[5])
    with pytest.raises(ValueError, match="mode must be"):
        _pipelined(s, cfg, loss, "avg", 2, "serial", None, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine.pipelined_step(
                towers.mlp_tower_apply, towers.mlp_tower_apply, loss,
                s["params"]["towers"], s["params"]["server"], s["feats"],
                torch.from_numpy(s["y"]), "avg")


def test_executor_accepts_nowait_and_refuses_the_rest():
    """The Executor takes ``mode="nowait"`` and ``drop_policy="impute"``,
    with cut compression too, as the JAX package's does; secure
    aggregation and trees are refused there by the compat matrix."""
    cfg, jcfg = _configs(TINY3)
    s = _setup(cfg, jcfg)
    loss, _ = _loss_fns(cfg.num_classes)
    tr = SimTransport([TowerWorker(k, towers.mlp_tower_apply,
                                   s["params"]["towers"][k])
                       for k in range(3)])
    args = (tr, towers.mlp_tower_apply, loss, "avg")
    for kw in (dict(mode="nowait"), dict(drop_policy="impute"),
               dict(mode="nowait", deadline=0.2),
               dict(mode="nowait", deadline=AdaptiveDeadline(3, 0.1)),
               dict(mode="nowait", compress="topk"),
               dict(drop_policy="impute", compress="int8")):
        Executor(*args, **kw)
    for kw, err, match in (
            (dict(mode="nowait", secure_agg=True), compat.CompatError,
             "barrier execution"),
            (dict(mode="nowait", agg_tree=object()), compat.CompatError,
             "barrier execution")):
        with pytest.raises(err, match=match):
            Executor(*args, **kw)
    ex = Executor(*args, mode="nowait", microbatches=2)
    live = [[1.0, 0.0, 1.0], [0.0, 1.0, 1.0]]
    res = ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                      features=s["feats"], liveness=live)
    assert res.report.live == live and res.report.misses_per_client == \
        [1, 1, 0]
    assert res.ema_state["initialized"].tolist() == [1.0, 1.0, 1.0]
    assert res.ledger.bytes_with_tag("jac[0]") == \
        res.ledger.bytes_with_tag("jac[2]") // 2


# ---------------------------------------------------------------------------
# train_split(runtime="nowait")
# ---------------------------------------------------------------------------

def test_train_split_nowait_without_straggler_equals_pipelined(monkeypatch):
    """Reduced smollm-360m, no straggler: no miss, step 0 verified against
    protocol_step, and every loss and final param within 1e-6 of the
    ``runtime="pipelined"`` run at the same M.  The adaptive window's
    bootstrap floor is raised to 5 s here, so that a healthy client is
    never late on a loaded test machine: the check is the numerics of the
    no-wait path, not the machine's scheduling."""
    seed = deadline_lib.AdaptiveDeadline.seed_from_observations
    monkeypatch.setattr(
        deadline_lib.AdaptiveDeadline, "seed_from_observations",
        lambda self, min_initial_s=5.0: seed(self, min_initial_s))
    cfg = get_arch("smollm-360m").reduced()
    runs = {}
    for runtime in ("pipelined", "nowait"):
        lines = []
        params, metrics, report = train_split(
            cfg, LMBatchLoader(cfg, 4, 16, seed=0), steps=3, batch=4,
            seq=16, runtime=runtime, microbatches=2, device="cpu",
            print_fn=lines.append)
        runs[runtime] = (params, metrics, report, lines)
    params, metrics, report, lines = runs["nowait"]
    assert report.total_misses == 0 and report.mode == "nowait"
    assert report.live == [[1.0] * cfg.vertical.num_clients] * 2
    assert metrics.step0_max_dgrad is not None
    assert any("misses=0" in line for line in lines)
    np.testing.assert_allclose(metrics.losses, runs["pipelined"][1].losses,
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(params)),
                    jax.tree_util.tree_leaves(to_numpy(runs["pipelined"][0]))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_train_split_nowait_with_straggler_skips_step0_verification():
    """A straggler that misses step 0's window: the verification is
    skipped by name, the run trains on, its losses are finite."""
    cfg = get_arch("smollm-360m").reduced()
    lines = []
    _, metrics, report = train_split(
        cfg, LMBatchLoader(cfg, 4, 16, seed=0), steps=2, batch=4, seq=16,
        runtime="nowait", microbatches=2, straggler=1,
        straggler_delay_s=0.5, device="cpu", print_fn=lines.append)
    assert all(np.isfinite(metrics.losses))
    assert metrics.step0_max_dgrad is None
    assert any("step-0 verification skipped" in line for line in lines)
    assert report.misses_per_client[1] >= 1
    assert report.misses_per_client[0] == 0


def test_train_split_still_refuses_unsound_nowait():
    cfg = get_arch("smollm-360m").reduced()
    loader = LMBatchLoader(cfg, 4, 16)
    with pytest.raises(compat.CompatError, match="barrier execution"):
        train_split(cfg, loader, steps=1, runtime="nowait",
                    agg_tree_fanout=2, device="cpu")
    secure = cfg.with_vertical(dataclasses.replace(cfg.vertical,
                                                   secure_aggregation=True))
    with pytest.raises(compat.CompatError, match="barrier execution"):
        train_split(secure, loader, steps=1, runtime="nowait", device="cpu")


# ---------------------------------------------------------------------------
# wall-clock no-wait over threads (behaviour, not values)
# ---------------------------------------------------------------------------

def _tiny3_workers(s, delays):
    return [TowerWorker(k, towers.mlp_tower_apply, s["params"]["towers"][k],
                        forward_delay_s=delays[k]) for k in range(3)]


def test_inproc_nowait_wallclock_straggler():
    """A client with a real (sleep-injected) slowdown misses the static
    wall-clock window on both microbatches and is EMA-imputed; the healthy
    majority merges; the straggler's tower gets zero gradient."""
    cfg, jcfg = _configs(TINY3)
    s = _setup(cfg, jcfg)
    loss, _ = _loss_fns(cfg.num_classes)
    with InprocTransport(_tiny3_workers(s, [0.0, STRAGGLER_DELAY_S, 0.0])) \
            as tr:
        ex = Executor(tr, towers.mlp_tower_apply, loss, cfg.merge,
                      mode="nowait", microbatches=2, deadline=0.15)
        res = ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                          features=s["feats"])
    assert res.report.misses_per_client == [0, 2, 0], res.report
    assert res.report.live == [[1.0, 0.0, 1.0]] * 2
    assert res.report.deadline_s == 0.15
    assert np.isfinite(float(res.loss))
    for leaf in res.tower_grads[1].values():
        assert float(leaf.abs().max()) == 0.0
    assert any(float(leaf.abs().max()) > 0
               for leaf in res.tower_grads[0].values())
    assert res.ema_state is not None
    assert res.ema_state["initialized"].tolist() == [1.0, 0.0, 1.0]


def test_inproc_nowait_busy_server_does_not_fabricate_misses():
    """A cut DELIVERED while role 0 was busy on an earlier microbatch beat
    the deadline and must not be imputed: the expired window sweeps the
    response queue before declaring a miss."""
    cfg, jcfg = _configs(TINY3)
    s = _setup(cfg, jcfg)
    loss, _ = _loss_fns(cfg.num_classes)
    slept = []

    def slow_loss(logits, labels):
        # the server stalls >> the window on the first microbatch only,
        # long enough for every mb-1 cut to be sitting in the queue
        if not slept:
            slept.append(True)
            time.sleep(1.0)
        return loss(logits, labels)

    with InprocTransport(_tiny3_workers(s, [0.0, 0.05, 0.0])) as tr:
        ex = Executor(tr, towers.mlp_tower_apply, slow_loss, cfg.merge,
                      mode="nowait", microbatches=2, deadline=0.3)
        res = ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                          features=s["feats"])
    assert res.report.misses_per_client == [0, 0, 0], res.report


def test_nowait_busy_server_clamps_deadline_observations():
    """A cut drained late because role 0 was busy is observed clamped to
    the window, so a busy role 0 cannot inflate the arrival EWMAs."""
    cfg, jcfg = _configs(TINY3)
    s = _setup(cfg, jcfg)
    loss, _ = _loss_fns(cfg.num_classes)
    slept = []

    def slow_loss(logits, labels):
        if not slept:
            slept.append(True)
            time.sleep(1.2)
        return loss(logits, labels)

    ctl = AdaptiveDeadline(3, initial_s=0.35)
    with InprocTransport(_tiny3_workers(s, [0.0, 0.05, 0.1])) as tr:
        ex = Executor(tr, towers.mlp_tower_apply, slow_loss, cfg.merge,
                      mode="nowait", microbatches=2, deadline=ctl)
        res = ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                          features=s["feats"])
    assert res.report.misses_per_client == [0, 0, 0], res.report
    for spread in ctl.spreads():
        assert spread is not None and spread <= 0.35 + 1e-6, ctl.spreads()


def test_adaptive_deadline_bootstraps_from_the_first_barrier():
    """``deadline=None``: the first microbatch waits for everyone, then the
    controller is seeded from its spreads and later microbatches run
    against a window; a late cut of a collected step still feeds the
    EWMA."""
    cfg, jcfg = _configs(TINY3)
    s = _setup(cfg, jcfg)
    loss, _ = _loss_fns(cfg.num_classes)
    with InprocTransport(_tiny3_workers(s, [0.0, 0.3, 0.0])) as tr:
        ex = Executor(tr, towers.mlp_tower_apply, loss, cfg.merge,
                      mode="nowait", microbatches=2)
        assert ex.deadline.deadline_s() is None
        res = ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                          features=s["feats"])
        assert res.report.live[0] == [1.0, 1.0, 1.0]  # the barrier
        assert ex.deadline.initial_s is not None
        assert res.report.misses_per_client[0] == 0
        assert res.report.misses_per_client[2] == 0
        res2 = ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                           step=1, features=s["feats"],
                           ema_state=res.ema_state)
    assert res2.report.deadline_s is not None
    assert np.isfinite(float(res2.loss))
    assert all(e is not None for e in ex.deadline.spreads())
