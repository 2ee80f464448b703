"""The port's AdamW, SGD, clipping and schedules against the JAX
package's.

A small param tree and five steps of gradients, made from a seed with
numpy, go through both optimizers: weight decay on, global-norm clipping
active (the gradients' norm is far above the clip), a warmup-cosine
schedule.  Params and both moments (SGD: the velocity) are held to each
other at 1e-6 after every step (f32 throughout; the two packages sum the global norm over
leaves in the same order and differ by rounding only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import SGD as JaxSGD
from repro.optim import AdamW as JaxAdamW
from repro.optim.clipping import clip_by_global_norm as jax_clip
from repro.optim.schedules import linear_warmup_cosine as jax_sched
from repro_torch.interop import to_numpy
from repro_torch.optim import SGD, AdamW
from repro_torch.optim.clipping import clip_by_global_norm
from repro_torch.optim.schedules import linear_warmup_cosine

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"embed": {"table": (7, 5)}, "blocks": {"w": (2, 5, 3), "b": (3,)},
          "scale": (5,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def build(spec):
        if isinstance(spec, dict):
            return {k: build(v) for k, v in spec.items()}
        return (rng.standard_normal(spec) * scale).astype(np.float32)

    return build(SHAPES)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _assert_close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_close(got[k], want[k])
        return
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("decay,clip", [(0.1, 1.0), (0.0, None)])
def test_adamw_matches_jax_moment_for_moment(decay, clip):
    kw = dict(learning_rate=None, weight_decay=decay, grad_clip_norm=clip)
    jopt = JaxAdamW(**dict(kw, learning_rate=jax_sched(3e-2, 2, 5)))
    topt = AdamW(**dict(kw, learning_rate=linear_warmup_cosine(3e-2, 2, 5)))
    params = _tree(0)
    jp = _map(jnp.asarray, params)
    tp = _map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        grads = _tree(100 + step, scale=3.0)  # global norm ~ 20 > clip
        handed, before = tp, _map(lambda t: t.numpy().copy(), tp)
        jp, js = jopt.update(jp, _map(jnp.asarray, grads), js)
        tp, ts = topt.update(tp, _map(torch.from_numpy, grads), ts)
        _assert_close(tp, jp)
        _assert_close(ts["mu"], js["mu"])
        _assert_close(ts["nu"], js["nu"])
        assert int(ts["count"]) == int(js["count"]) == step + 1
        assert ts["count"].dtype == torch.int32
        assert ts["mu"]["scale"].dtype == torch.float32
        # out of place: the tensors handed in are untouched
        _assert_close(handed, before)
    assert not torch.equal(tp["scale"], torch.from_numpy(params["scale"]))


def test_clip_by_global_norm_matches_jax():
    grads = _tree(9, scale=4.0)
    jc, jn = jax_clip(_map(jnp.asarray, grads), 1.5)
    tc, tn = clip_by_global_norm(_map(torch.from_numpy, grads), 1.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_close(tc, jc)
    small = _map(lambda a: a * 1e-3, grads)  # under the clip: unchanged
    tc, _ = clip_by_global_norm(_map(torch.from_numpy, small), 1.5)
    _assert_close(tc, small)


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 20, 100), (1e-2, 2, 5),
                                               (5e-3, 0, 10)])
def test_linear_warmup_cosine_matches_jax(peak, warmup, total):
    jf, tf = jax_sched(peak, warmup, total), linear_warmup_cosine(
        peak, warmup, total)
    for count in (0, 1, warmup // 2, warmup, warmup + 1, total // 2, total,
                  total + 7):
        got = tf(torch.tensor(count, dtype=torch.int32))
        want = jf(jnp.asarray(count, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("momentum,nesterov,clip,schedule", [
    (0.0, False, None, False), (0.9, False, None, False),
    (0.9, True, None, True), (0.9, False, 1.0, False), (0.0, False, 1.0, True)])
def test_sgd_matches_jax_step_for_step(momentum, nesterov, clip, schedule):
    """Plain and momentum SGD, Nesterov, global-norm clipping (active: the
    gradients' norm is ~20) and a callable schedule."""
    kw = dict(momentum=momentum, nesterov=nesterov, grad_clip_norm=clip)
    jopt = JaxSGD(learning_rate=jax_sched(5e-2, 2, 5) if schedule else 5e-2,
                  **kw)
    topt = SGD(learning_rate=linear_warmup_cosine(5e-2, 2, 5) if schedule
               else 5e-2, **kw)
    params = _tree(1)
    jp = _map(jnp.asarray, params)
    tp = _map(torch.from_numpy, params)
    js, ts = jopt.init(jp), topt.init(tp)
    assert set(ts) == set(js)
    for step in range(5):
        grads = _tree(200 + step, scale=3.0)
        handed, before = tp, _map(lambda t: t.numpy().copy(), tp)
        jp, js = jopt.update(jp, _map(jnp.asarray, grads), js)
        tp, ts = topt.update(tp, _map(torch.from_numpy, grads), ts)
        _assert_close(tp, jp)
        if momentum:
            _assert_close(ts["velocity"], js["velocity"])
            assert ts["velocity"]["scale"].dtype == torch.float32
        assert int(ts["count"]) == int(js["count"]) == step + 1
        assert ts["count"].dtype == torch.int32
        _assert_close(handed, before)  # out of place


@pytest.mark.parametrize("clip", [1.0, None], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_inplace_matches_out_of_place_bit_for_bit(clip, dtype,
                                                        monkeypatch):
    """``AdamW(inplace=True)`` writes the params, both moments and (when
    clipping) the gradients into the tensors it is handed, and gives the
    out-of-place update's values bit for bit over 3 updates (a bf16 tree
    too, its moments f32), walking each leaf in slices (a slice of 16
    elements here, so every leaf of more spans several) and a
    non-contiguous leaf whole."""
    from repro_torch import tree_util
    from repro_torch.tree_util import tree_leaves, tree_map

    monkeypatch.setattr(tree_util, "SLICE", 16)
    kw = dict(learning_rate=linear_warmup_cosine(3e-2, 2, 5),
              weight_decay=0.1, grad_clip_norm=clip)
    out, inp = AdamW(**kw), AdamW(**kw, inplace=True)

    def tensors(seed, scale=1.0):
        tree = _map(lambda a: torch.from_numpy(a).to(dtype),
                    _tree(seed, scale))
        tree["blocks"]["w"] = tree["blocks"]["w"].transpose(1, 2)
        return tree

    p, q = tensors(0), tensors(0)
    so, si = out.init(p), inp.init(q)
    handed = tree_leaves((q, si["mu"], si["nu"]))
    for step in range(3):
        grads = tensors(100 + step, scale=3.0)
        p, so = out.update(p, grads, so)
        given = tree_map(torch.clone, grads)
        q2, si = inp.update(q, given, si)
        assert q2 is q
        assert all(a is b for a, b in zip(
            tree_leaves((q, si["mu"], si["nu"])), handed))
        if clip is None:  # the gradients are left as they were
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(given), tree_leaves(grads)))
        else:  # clipped in place
            assert not torch.equal(given["scale"], grads["scale"])
    for a, b in zip(tree_leaves((p, so)), tree_leaves((q, si))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert si["mu"]["scale"].dtype == torch.float32


ALL_FAMILIES = ["smollm-360m", "deepseek-moe-16b", "mamba2-1.3b",
                "zamba2-7b", "whisper-tiny", "internvl2-26b"]


@pytest.mark.parametrize("arch", ALL_FAMILIES)
def test_partition_gives_every_tower_its_own_storage(arch):
    """After ``partition`` no tower tensor shares storage with the server
    tree or with another tower, in every family (the training loops
    update in place), and each tower holds the monolithic tree's values.
    A feature holder that trains keeps such a copy too; one that only
    serves keeps ``tower_params``' views into the tree."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models import backbone, split_program
    from repro_torch.transport import build_split_worker
    from repro_torch.tree_util import tree_leaves

    cfg = get_arch(arch).reduced()
    params = backbone.init_params(cfg, device="cpu")
    prog = split_program.get_program(cfg)
    towers, server = prog.partition(params)

    def storages(tree):
        return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)}

    server_ptrs, seen = storages(server), set()
    assert server_ptrs <= storages(params)
    for k, tp in enumerate(towers):
        mine = storages(tp)
        assert not mine & (server_ptrs | seen | storages(params))
        seen |= mine
        views = prog.tower_params(params, k)
        assert storages(views) <= storages(params)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp),
                                                     tree_leaves(views)))
        trains, serves = (build_split_worker(
            k, cfg=cfg, params=params, device="cpu", learning_rate=lr)
            for lr in (1e-3, None))
        assert not storages(trains.params) & (mine | storages(params))
        assert storages(serves.params) <= storages(params)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(tp), tree_leaves(trains.params)))
