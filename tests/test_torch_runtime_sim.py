"""The port's simulation layer against the JAX package: the event clock,
the link model, the aggregation tree, the adaptive deadline, the step
plans, both simulators and the cost models and placement advisors that
read them.

All of it is pure timing on the host (no tensors, no RNG), so every
result must equal the JAX package's EXACTLY: each ``SimReport`` field by
field, each ``StepPlan``, each advisor dict.  The grid covers K in
{2, 4, 8}; serial, pipelined and nowait; with and without a straggler;
multi-step runs at a cross-step window; and plans with secure
aggregation, compression and an aggregation tree.
"""
import dataclasses

import pytest

from repro.configs.base import get_arch as jax_get_arch
from repro.configs.vertical_mlp import MLPSplitConfig as JaxMLPSplitConfig
from repro.core import compat as jax_compat
from repro.core import costs as jax_costs
from repro.runtime import clock as jax_clock
from repro.runtime import engine as jax_engine
from repro.runtime.deadline import AdaptiveDeadline as JaxAdaptiveDeadline
from repro.runtime.links import LinkModel as JaxLinkModel
from repro.runtime.topology import TREE_VERIFY_ATOL as JAX_TREE_ATOL
from repro.runtime.topology import AggTree as JaxAggTree
from repro_torch.configs.base import get_arch
from repro_torch.configs.vertical_mlp import MLPSplitConfig
from repro_torch.core import compat, costs
from repro_torch.runtime import clock, engine
from repro_torch.runtime.deadline import AdaptiveDeadline
from repro_torch.runtime.links import LinkModel
from repro_torch.runtime.topology import TREE_VERIFY_ATOL, AggTree

KS = (2, 4, 8)
ARCHS = ("smollm-360m", "starcoder2-3b", "mamba2-1.3b")


def _mlp(K: int, merge: str = "avg"):
    """A K-client MLP config in both packages (the same fields)."""
    fields = dict(name=f"sim_k{K}", input_dim=12 * K, num_classes=3,
                  num_clients=K, client_feature_sizes=(12,) * K,
                  tower_hidden=(32, 24), cut_dim=16, server_hidden=(48,),
                  merge=merge)
    return MLPSplitConfig(**fields), JaxMLPSplitConfig(**fields)


def _links(K: int, straggler: bool, **kw):
    port, ref = LinkModel.uniform(K, **kw), JaxLinkModel.uniform(K, **kw)
    if straggler:
        port = port.with_straggler(K - 1, slowdown=20.0)
        ref = ref.with_straggler(K - 1, slowdown=20.0)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    return port, ref


def _same(port_obj, ref_obj) -> None:
    """Field by field, exactly (floats included)."""
    a, b = dataclasses.asdict(port_obj), dataclasses.asdict(ref_obj)
    assert a == b
    if hasattr(ref_obj, "total_misses"):
        assert port_obj.total_misses == ref_obj.total_misses


# (plan kwargs, simulate kwargs, link kwargs) per variant
VARIANTS = {
    "plain": ({}, {}, {}),
    "multistep": ({}, dict(steps=3, cross_step=2), {}),
    "secure": (dict(secure=True), {}, {}),
    "topk": (dict(compress="topk", topk_fraction=0.25), {}, {}),
    "int8": (dict(compress="int8"), dict(steps=2, cross_step=2), {}),
    "tree": (dict(tree_fanout=2), {}, dict(server_bandwidth_bps=2e7)),
    "tree_multistep": (dict(tree_fanout=3), dict(steps=3, cross_step=2),
                       dict(server_bandwidth_bps=5e7)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("straggler", [False, True])
@pytest.mark.parametrize("mode", ["serial", "pipelined", "nowait"])
@pytest.mark.parametrize("K", KS)
def test_sim_reports_equal_jax(K, mode, straggler, variant):
    plan_kw, sim_kw, link_kw = VARIANTS[variant]
    cfg, jcfg = _mlp(K)
    plan = engine.plan_step(cfg, 64, 4, **plan_kw)
    jplan = jax_engine.plan_step(jcfg, 64, 4, **plan_kw)
    _same(plan, jplan)
    link, jlink = _links(K, straggler, **link_kw)
    if mode == "serial":
        steps = sim_kw.get("steps", 1)
        _same(engine.simulate_serial(plan, link, steps=steps),
              jax_engine.simulate_serial(jplan, jlink, steps=steps))
        return
    if mode == "nowait" and plan.tree_fanout:
        # both packages refuse a tree in no-wait, with the same words
        with pytest.raises(jax_compat.CompatError) as want:
            jax_engine.simulate_pipelined(jplan, jlink, mode=mode, **sim_kw)
        with pytest.raises(compat.CompatError) as got:
            engine.simulate_pipelined(plan, link, mode=mode, **sim_kw)
        assert str(got.value) == str(want.value)
        return
    got = engine.simulate_pipelined(plan, link, mode=mode, **sim_kw)
    want = jax_engine.simulate_pipelined(jplan, jlink, mode=mode, **sim_kw)
    _same(got, want)
    if mode == "nowait" and straggler:
        # the straggler misses: the grid exercises the imputation path
        assert got.misses_per_client[K - 1] > 0


@pytest.mark.parametrize("K", KS)
def test_nowait_deadlines_equal_jax(K):
    """A static window, and an explicit controller whose EWMAs the clock
    feeds: the same reports and the same learned spreads."""
    cfg, jcfg = _mlp(K)
    plan = engine.plan_step(cfg, 128, 8)
    jplan = jax_engine.plan_step(jcfg, 128, 8)
    link, jlink = _links(K, True)
    d = engine.default_deadline_s(plan, link)
    assert d == jax_engine.default_deadline_s(jplan, jlink)
    _same(engine.simulate_pipelined(plan, link, mode="nowait",
                                    deadline_s=0.5 * d, steps=2),
          jax_engine.simulate_pipelined(jplan, jlink, mode="nowait",
                                        deadline_s=0.5 * d, steps=2))
    ctl, jctl = AdaptiveDeadline(K, initial_s=d), JaxAdaptiveDeadline(
        K, initial_s=d)
    _same(engine.simulate_pipelined(plan, link, mode="nowait", deadline=ctl,
                                    steps=3, cross_step=2),
          jax_engine.simulate_pipelined(jplan, jlink, mode="nowait",
                                        deadline=jctl, steps=3, cross_step=2))
    assert ctl.spreads() == jctl.spreads()
    assert ctl.deadline_s() == jctl.deadline_s()


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_from_arch_equals_jax(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for batch, seq, M in ((8, 256, 1), (8, 256, 4), (4, 2048, 2)):
        _same(engine.plan_from_arch(cfg, batch, seq, M),
              jax_engine.plan_from_arch(jcfg, batch, seq, M))
    for kw in (dict(secure=True), dict(compress="topk", topk_fraction=0.1),
               dict(compress="int8"), dict(tree_fanout=2),
               dict(bytes_per_elt=2)):
        _same(engine.plan_from_arch(cfg, 8, 256, 4, **kw),
              jax_engine.plan_from_arch(jcfg, 8, 256, 4, **kw))
    link, jlink = _links(cfg.vertical.num_clients, True)
    plan = engine.plan_from_arch(cfg, 8, 256, 4)
    jplan = jax_engine.plan_from_arch(jcfg, 8, 256, 4)
    for mode in ("pipelined", "nowait"):
        _same(engine.simulate_pipelined(plan, link, mode=mode, steps=2),
              jax_engine.simulate_pipelined(jplan, jlink, mode=mode,
                                            steps=2))


@pytest.mark.parametrize("objective", ["heuristic", "serial", "pipelined"])
@pytest.mark.parametrize("cross_step", [1, 2])
@pytest.mark.parametrize("tree_fanout", [None, 2])
def test_advise_split_depth_equals_jax(objective, cross_step, tree_fanout):
    cfg, jcfg = _mlp(4)
    rates = [dict(bandwidth_bytes_per_s=1e6, client_flops_per_s=1e9,
                  server_flops_per_s=1e11),
             dict(bandwidth_bytes_per_s=1e10, client_flops_per_s=1e8,
                  server_flops_per_s=1e12, latency_s=1e-3)]
    for kw in rates:
        kw = dict(kw, batch_size=64, objective=objective,
                  cross_step=cross_step, tree_fanout=tree_fanout)
        assert costs.advise_split_depth(cfg, **kw) == \
            jax_costs.advise_split_depth(jcfg, **kw)


@pytest.mark.parametrize("objective", ["serial", "pipelined"])
@pytest.mark.parametrize("arch", ARCHS)
def test_advise_arch_split_depth_equals_jax(arch, objective):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for kw in (dict(), dict(cross_step=2, bandwidth_bytes_per_s=1e9),
               dict(tree_fanout=2, microbatches=2)):
        kw = dict(kw, batch_size=8, seq_len=256, objective=objective)
        assert costs.advise_arch_split_depth(cfg, **kw) == \
            jax_costs.advise_arch_split_depth(jcfg, **kw)


def test_adaptive_deadline_equals_jax():
    """The twin of the JAX package's controller test, fed the same
    observations: identical deadlines at every point, including the
    bootstrap (no estimate, then seeded from the median)."""
    for initial in (1.0, None):
        ctl = AdaptiveDeadline(4, initial_s=initial, decay=0.5)
        jctl = JaxAdaptiveDeadline(4, initial_s=initial, decay=0.5)
        seen = [(ctl.deadline_s(), jctl.deadline_s())]
        if initial is None:
            for k in range(4):
                ctl.observe(k, 0.02 * k)
                jctl.observe(k, 0.02 * k)
            seen.append((ctl.deadline_s(), jctl.deadline_s()))
            ctl.seed_from_observations()
            jctl.seed_from_observations()
            assert ctl.initial_s == jctl.initial_s
        for rounds, slow in ((4, 5.0), (20, 0.4), (3, -1.0)):
            for _ in range(rounds):
                for k in range(3):
                    ctl.observe(k, 0.01 * (k + 1))
                    jctl.observe(k, 0.01 * (k + 1))
                ctl.observe(3, slow)
                jctl.observe(3, slow)
                seen.append((ctl.deadline_s(), jctl.deadline_s()))
        assert all(a == b for a, b in seen), seen
        assert ctl.spreads() == jctl.spreads()
    d = AdaptiveDeadline(4, initial_s=1.0, decay=0.5)
    for _ in range(4):
        for k in range(3):
            d.observe(k, 0.01 * (k + 1))
        d.observe(3, 5.0)
    assert d.floor_frac * 1.0 - 1e-9 <= d.deadline_s() < 1.0


def test_event_clock_and_resource_equal_jax():
    """Same-instant events fire in insertion order, a past time clamps to
    now, and a resource grants slots FIFO in acquire order."""
    logs = []
    for mod in (clock, jax_clock):
        log = []
        ck = mod.EventClock()
        res = mod.Resource("r")

        def job(tag, d, ck=ck, res=res, log=log):
            log.append((tag, ck.now, res.acquire(ck.now, d)))
            if tag == "a":
                ck.post(0.0, lambda: job("late", 0.5))  # clamps to now
                ck.post_in(0.0, lambda: job("tie", 0.25))

        for i, tag in enumerate("abc"):
            ck.post(1.0, lambda tag=tag, i=i: job(tag, 0.1 * (i + 1)))
        ck.post(0.5, lambda: job("early", 2.0))
        log.append(("end", ck.run(), res.busy_s, res.utilization(4.0)))
        logs.append(log)
    assert logs[0] == logs[1]


@pytest.mark.parametrize("K,F", [(1, 2), (4, 4), (7, 2), (13, 3), (40, 3)])
def test_agg_tree_equals_jax(K, F):
    tree, jtree = AggTree(K, F), JaxAggTree(K, F)
    for k in range(K):
        assert tree.parent(k) == jtree.parent(k)
        assert tree.children(k) == jtree.children(k)
        assert tree.subtree(k) == jtree.subtree(k)
        assert tree.edge_level(k) == jtree.edge_level(k)
    for name in ("top_level", "relays", "leaves", "depth", "is_star"):
        assert getattr(tree, name) == getattr(jtree, name)
    assert costs.tree_cut_bytes(tree, 4096, 3) == \
        jax_costs.tree_cut_bytes(jtree, 4096, 3)
    assert TREE_VERIFY_ATOL == JAX_TREE_ATOL
    for bad in ((0, 2), (3, 1)):
        with pytest.raises(ValueError):
            AggTree(*bad)


def test_byte_models_equal_jax():
    for K in KS:
        assert costs.key_exchange_bytes(K) == jax_costs.key_exchange_bytes(K)
        assert costs.key_exchange_bytes(K, 32) == \
            jax_costs.key_exchange_bytes(K, 32)
    assert costs.masked_cut_bytes(64, 240) == \
        jax_costs.masked_cut_bytes(64, 240)
    for shape in ((64, 16), (2, 256, 240), (3, 7)):
        for scheme in (None, "topk", "int8"):
            for dtype_bytes, frac in ((4, 0.25), (2, 0.1)):
                assert costs.wire_bytes(shape, dtype_bytes, scheme, frac) == \
                    jax_costs.wire_bytes(shape, dtype_bytes, scheme, frac)
    with pytest.raises(ValueError):
        costs.wire_bytes((4, 4), 4, "zip")


def test_engine_refuses_as_jax():
    """Unsound plans reject through the compat matrix, with the JAX
    package's words; bad arguments raise ValueError in both."""
    cfg, jcfg = _mlp(4, merge="max")
    for kw in (dict(secure=True, compress="int8"), dict(tree_fanout=2),
               dict(tree_fanout=2, compress="topk")):
        with pytest.raises(jax_compat.CompatError) as want:
            jax_engine.plan_step(jcfg, 64, 4, **kw)
        with pytest.raises(compat.CompatError) as got:
            engine.plan_step(cfg, 64, 4, **kw)
        assert str(got.value) == str(want.value)
    avg, _ = _mlp(4)
    for args, kw in (((avg, 63, 4), {}), ((avg, 64, 4), dict(tree_fanout=1))):
        with pytest.raises(ValueError):
            engine.plan_step(*args, **kw)
    plan = engine.plan_step(avg, 64, 4)
    with pytest.raises(ValueError, match="pipelined|nowait"):
        engine.simulate_pipelined(plan, LinkModel.uniform(4), mode="serial")
    with pytest.raises(ValueError, match="disagree on K"):
        engine.simulate_pipelined(plan, LinkModel.uniform(3))
    with pytest.raises(ValueError, match="steps/cross_step"):
        engine.simulate_pipelined(plan, LinkModel.uniform(4), steps=0)
