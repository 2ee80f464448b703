"""Compressed cut traffic on the port's execution path against the JAX
package (the twin of ``tests/test_compressed_exec.py``).

- The Executor over ``SimTransport`` and ``InprocTransport`` at M = 2,
  with the workers compressing their uplinks and role 0 its downlinks,
  against the JAX package's serial ``protocol_step`` running the same
  codec: the paper MLP and reduced smollm-360m, at
  ``compression.STEP0_VERIFY_ATOL``; every ``compressed_cut[k]`` /
  ``compressed_jac[k]`` byte equal to ``costs.wire_bytes``.
- Error feedback: the uplinks follow ``C(cut)``, then ``C(cut + r0)``,
  exactly; the same byte-identical uplink sequence at window 1 and 2.
- Tied magnitudes keep exactly k per vector and reconcile the bytes.
- The rejections, with the JAX package's words.
- ``train_split`` (inproc) verifies step 0 in-run at window 1 and 2 and
  audits every step's bytes; one multiproc loopback (K = 2) matches the
  JAX serial step and audits its bytes.

Inputs from numpy with a seed; the JAX package's params carried across by
``interop``.  f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core import compression as jax_comp
from repro.core import protocol as jax_protocol
from repro.core import split_model as jax_split_model
from repro.core import towers as jax_towers
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.models import backbone as jax_backbone
from repro.models import split_program as jax_split_program
from repro.runtime.executor import Executor as JaxExecutor
from repro.transport import SimTransport as JaxSimTransport
from repro.transport.base import TowerWorker as JaxTowerWorker
from repro_torch.configs.base import get_arch
from repro_torch.configs.vertical_mlp import MLPSplitConfig
from repro_torch.core import compat, costs, protocol, split_model, towers
from repro_torch.core import compression as comp
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import split_program
from repro_torch.runtime.executor import Executor
from repro_torch.runtime.pipeline import StepPipeline
from repro_torch.train.loop import train_split
from repro_torch.transport import (InprocTransport, MultiprocTransport,
                                   SimTransport, TowerWorker, WorkerSpec,
                                   build_mlp_worker)

TINY = MLPSplitConfig(
    name="comp_tiny", input_dim=16, num_classes=2, num_clients=3,
    client_feature_sizes=(6, 5, 5), tower_hidden=(16,), cut_dim=8,
    server_hidden=(16,), merge="avg")
FRACTION = 0.25
ATOL = comp.STEP0_VERIFY_ATOL
TRANSPORTS = {"sim": SimTransport, "inproc": InprocTransport}
RUN_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread here and in every spawned child: the suite
    runs in parallel worker processes."""
    import os

    before, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(before)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _mlp(cfg, batch=16, seed=0):
    jparams = jax_split_model.init_split_mlp(jax.random.PRNGKey(seed), cfg)
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


def _close(got, want, atol):
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=1e-3)


def _audit(ledger, K, rows, cut_dim, M, scheme):
    """Every cut and jacobian byte rides the compressed tags at exactly the
    codec's analytic wire bytes; the plain tags are empty."""
    want = M * costs.wire_bytes((rows, cut_dim), 4, scheme, FRACTION)
    for k in range(K):
        assert ledger.bytes_with_tag(f"compressed_cut[{k}]") == want
        assert ledger.bytes_with_tag(f"compressed_jac[{k}]") == want
        assert ledger.bytes_with_tag(f"cut[{k}]") == 0
        assert ledger.bytes_with_tag(f"jac[{k}]") == 0


class RecordingSimTransport(SimTransport):
    """What role 0 observes on the uplink, per (step, mb, client)."""

    def __init__(self, workers):
        super().__init__(workers)
        self.observed: dict = {}

    def next_response(self, timeout=None):
        got = super().next_response(timeout)
        if got is not None and got[1]["op"] == "cut":
            r = got[1]
            self.observed[(r["step"], r["mb"], got[0])] = r["cut"].clone()
        return got


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("scheme", comp.SCHEMES)
def test_compressed_matches_jax_serial_mlp(scheme, transport):
    """M = 2 over a transport reproduces the JAX serial ``protocol_step``
    running the same codec (both from the zero residual); the ledger
    audits the codec's bytes exactly."""
    cfg, M = TINY, 2
    s = _mlp(cfg)
    loss_s, tg_s, sg_s, _ = jax_protocol.protocol_step(
        jax_towers.mlp_tower_apply, jax_towers.mlp_tower_apply, s["jloss"],
        s["jparams"]["towers"], s["jparams"]["server"], s["jfeats"],
        jnp.asarray(s["y"]), cfg.merge, compress=scheme,
        topk_fraction=FRACTION)
    tr = TRANSPORTS[transport]([
        TowerWorker(k, towers.mlp_tower_apply, s["params"]["towers"][k],
                    compress=scheme, topk_fraction=FRACTION)
        for k in range(cfg.num_clients)])
    try:
        res = Executor(tr, towers.mlp_tower_apply, s["loss"], cfg.merge,
                       microbatches=M, compress=scheme,
                       topk_fraction=FRACTION).run_step(
            s["params"]["server"], torch.from_numpy(s["y"]),
            features=s["feats"])
    finally:
        tr.close()
    np.testing.assert_allclose(float(res.loss), float(loss_s), atol=ATOL)
    _close((res.tower_grads, res.server_grads), (tg_s, sg_s), ATOL)
    _audit(res.ledger, cfg.num_clients, 16 // M, cfg.cut_dim, M, scheme)
    # the port's own serial reference takes the same codec
    loss_p, tg_p, sg_p, led = protocol.protocol_step(
        towers.mlp_tower_apply, towers.mlp_tower_apply, s["loss"],
        s["params"]["towers"], s["params"]["server"], s["feats"],
        torch.from_numpy(s["y"]), cfg.merge, compress=scheme,
        topk_fraction=FRACTION)
    _close((tg_p, sg_p), (tg_s, sg_s), 1e-5)
    _audit(led, cfg.num_clients, 16, cfg.cut_dim, 1, scheme)


@pytest.fixture(scope="module")
def lm():
    jcfg = jax_get_arch("smollm-360m").reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    batch = next(iter(JaxLMBatchLoader(jcfg, 2, 16, seed=0)))
    return dict(jcfg=jcfg, cfg=get_arch("smollm-360m").reduced(),
                jparams=jparams, batch=batch, refs={},
                params=params_from_numpy(
                    jax.tree_util.tree_map(np.asarray, jparams), "cpu"))


def _lm_reference(lm, scheme):
    """The JAX program's serial step with the codec ``scheme``, run once
    each: the JAX package steps op by op here."""
    if scheme not in lm["refs"]:
        jcfg = lm["jcfg"]
        jprog = jax_split_program.get_program(jcfg.with_vertical(
            dataclasses.replace(jcfg.vertical, compression=scheme,
                                topk_fraction=FRACTION)))
        jtow, jserv = jprog.partition(lm["jparams"])
        jb = {k: jnp.asarray(v) for k, v in lm["batch"].items()}
        lm["refs"][scheme] = jprog.protocol_step(
            jtow, jserv, jprog.features(jb), jprog.batch_ctx(jb))
    return lm["refs"][scheme]


@pytest.mark.parametrize("scheme", comp.SCHEMES)
def test_compressed_lm_matches_jax(lm, scheme):
    """Reduced smollm-360m over the inline transport: the compressed wire
    path against the JAX program's compressed serial step at
    ``STEP0_VERIFY_ATOL`` (the threaded transport is held to the inline
    one in the MLP test above and by ``train_split`` below)."""
    def codec(c):
        return c.with_vertical(dataclasses.replace(
            c.vertical, compression=scheme, topk_fraction=FRACTION))

    prog = split_program.get_program(codec(lm["cfg"]))
    tow, serv = prog.partition(lm["params"])
    loss_c, tg_c, sg_c, _ = _lm_reference(lm, scheme)
    tr = SimTransport([
        TowerWorker(k, prog.tower_fwd(k), tow[k], compress=scheme,
                    topk_fraction=FRACTION)
        for k in range(prog.num_clients)])
    try:
        res = Executor(tr, prog.server_fwd, prog.loss_fn, prog.merge,
                       compress=scheme, topk_fraction=FRACTION).run_step(
            serv, prog.batch_ctx(lm["batch"], "cpu"),
            features=prog.features(lm["batch"], "cpu"))
    finally:
        tr.close()
    np.testing.assert_allclose(float(res.loss), float(loss_c), atol=ATOL)
    _close((res.tower_grads, res.server_grads), (tg_c, sg_c), ATOL)
    _audit(res.ledger, prog.num_clients, 2 * 16, lm["cfg"].d_model, 1,
           scheme)


@pytest.mark.parametrize("scheme", comp.SCHEMES)
def test_error_feedback_residual_carries_across_steps(scheme):
    """Frozen params, the same features every step: the uplinks are
    ``C(cut)`` then ``C(cut + r0)`` with ``r0 = cut - C(cut)``, the JAX
    package's codec on the same cut, exactly."""
    cfg = TINY
    s = _mlp(cfg, batch=8)
    tr = RecordingSimTransport([
        TowerWorker(k, towers.mlp_tower_apply, s["params"]["towers"][k],
                    compress=scheme, topk_fraction=FRACTION)
        for k in range(cfg.num_clients)])
    ex = Executor(tr, towers.mlp_tower_apply, s["loss"], cfg.merge,
                  compress=scheme, topk_fraction=FRACTION)
    for step in range(2):
        ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                    step=step, features=s["feats"], collect_grads=False)
    for k in range(cfg.num_clients):
        raw = jnp.asarray(towers.mlp_tower_apply(
            s["params"]["towers"][k], s["feats"][k]).numpy())
        c0 = jax_comp.apply_compression(raw, scheme, FRACTION)
        c1 = jax_comp.apply_compression(raw + (raw - c0), scheme, FRACTION)
        np.testing.assert_array_equal(tr.observed[(0, 0, k)].numpy(), c0)
        np.testing.assert_array_equal(tr.observed[(1, 0, k)].numpy(), c1)
        assert float(jnp.max(jnp.abs(c1 - c0))) > 0


@pytest.mark.parametrize("scheme", comp.SCHEMES)
def test_error_feedback_identical_at_window_1_and_2(scheme):
    """Steps are collected oldest first, so window 2 ships the byte-identical
    uplink sequence window 1 does (frozen params)."""
    cfg, steps = TINY, 4
    s = _mlp(cfg, batch=8)

    def run(window):
        tr = RecordingSimTransport([
            TowerWorker(k, towers.mlp_tower_apply,
                        s["params"]["towers"][k], compress=scheme,
                        topk_fraction=FRACTION)
            for k in range(cfg.num_clients)])
        pipe = StepPipeline(Executor(
            tr, towers.mlp_tower_apply, s["loss"], cfg.merge,
            compress=scheme, topk_fraction=FRACTION), window=window)
        losses = []
        for step in range(steps):
            pipe.submit(step, torch.from_numpy(s["y"]), features=s["feats"])
            if pipe.inflight >= window:
                losses.append(float(pipe.collect(
                    s["params"]["server"], collect_grads=False).loss))
        while pipe.inflight:
            losses.append(float(pipe.collect(
                s["params"]["server"], collect_grads=False).loss))
        return losses, tr.observed

    losses1, cuts1 = run(1)
    losses2, cuts2 = run(2)
    assert losses1 == losses2 and cuts1.keys() == cuts2.keys()
    for key in cuts1:
        assert torch.equal(cuts1[key], cuts2[key])


def test_tied_magnitudes_keep_exactly_k_and_reconcile_bytes():
    """All-equal magnitudes: exactly k nonzeros per vector on the wire, and
    the ledger equals ``costs.wire_bytes``."""
    cfg, M = TINY, 2
    s = _mlp(cfg, batch=8)

    def tied_tower(tp, x):
        # every magnitude 1.0, a zero dependence on one weight: the tower
        # backward gives the unread params zeros, as jax.grad does
        return torch.ones((x.shape[0], cfg.cut_dim)) + 0.0 * tp["w0"].sum()

    tr = RecordingSimTransport([
        TowerWorker(k, tied_tower, s["params"]["towers"][k],
                    compress="topk", topk_fraction=FRACTION)
        for k in range(cfg.num_clients)])
    res = Executor(tr, towers.mlp_tower_apply, s["loss"], cfg.merge,
                   microbatches=M, compress="topk",
                   topk_fraction=FRACTION).run_step(
        s["params"]["server"], torch.from_numpy(s["y"]),
        features=s["feats"], collect_grads=False)
    k_keep = comp.topk_count(cfg.cut_dim, FRACTION)
    for cut in tr.observed.values():
        assert ((cut != 0).sum(-1) == k_keep).all()
    want = M * costs.wire_bytes((8 // M, cfg.cut_dim), 4, "topk", FRACTION)
    for c in range(cfg.num_clients):
        assert res.ledger.bytes_with_tag(f"compressed_cut[{c}]") == want


def test_unsupported_combinations_raise_with_the_jax_words():
    """Executor, schedule and worker reject as the JAX package's do."""
    cases = [
        lambda E, S, W: E(S([]), None, None, "avg", secure_agg=True,
                          compress="topk"),
        lambda E, S, W: E(S([]), None, None, "avg", compress="gzip"),
        lambda E, S, W: W(0, None, {}, compress="gzip"),
        lambda E, S, W: W(0, None, {}, compress="topk").handle(
            {"op": "key_exchange", "phase": "pub"}),
        lambda E, S, W: W(0, None, {}, compress="int8").handle(
            {"op": "configure_relay", "children": [1]}),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(JaxExecutor, JaxSimTransport, JaxTowerWorker)
        with pytest.raises(ValueError) as got:
            case(Executor, SimTransport, TowerWorker)
        assert str(got.value) == str(want.value)
    with pytest.raises(compat.CompatError, match="cannot compose"):
        protocol.step_schedule(2, secure=True, compress="topk")
    cfg = get_arch("smollm-360m").reduced()
    cfg = cfg.with_vertical(dataclasses.replace(
        cfg.vertical, secure_aggregation=True, compression="topk"))
    with pytest.raises(compat.CompatError, match="cannot compose"):
        train_split(cfg, LMBatchLoader(cfg, 2, 16), steps=1, batch=2,
                    seq=16, device="cpu")


@pytest.mark.parametrize("scheme,runtime,window", [
    ("topk", "serial", 1), ("int8", "pipelined", 2)])
def test_train_split_compressed_verifies_step0(lm, scheme, runtime, window):
    """Split training with a codec over threads verifies its compressed
    step 0 in-run against the serial ``protocol_step`` (held to the JAX
    package's above) at ``STEP0_VERIFY_ATOL``, at window 1 and 2, prints
    the uplink ratio, and ledgers every step at the codec's bytes."""
    cfg = lm["cfg"].with_vertical(dataclasses.replace(
        lm["cfg"].vertical, compression=scheme, topk_fraction=FRACTION))
    M = 2 if runtime == "pipelined" else 1
    lines = []
    _, metrics, report = train_split(
        cfg, LMBatchLoader(cfg, 4, 16), steps=3, batch=4, seq=16,
        runtime=runtime, microbatches=M, inflight_steps=window,
        device="cpu", params=lm["params"], print_fn=lines.append)
    assert any("compressed-wire verification" in ln for ln in lines)
    ratio = "(0.28x)" if scheme == "topk" else "(0.26x)"
    assert any(f"compressed cut uplink ({scheme})" in ln and ratio in ln
               for ln in lines)
    assert metrics.step0_max_dgrad <= ATOL
    assert report.staleness == window - 1 and len(metrics.losses) == 3
    cut_bytes = M * costs.wire_bytes((4 // M, 16, cfg.d_model), 4, scheme,
                                     FRACTION)
    for ledger in metrics.ledgers:
        assert ledger.bytes_with_tag("compressed_cut[1]") == cut_bytes
        assert ledger.bytes_with_tag("compressed_jac[0]") == cut_bytes


def test_multiproc_compressed_loopback_matches_and_audits():
    """Over two spawned processes (features and params injected as numpy):
    top-k uplinks and downlinks cross TCP, the gradients match the JAX
    serial step running the codec, the ledger reconciles, no child
    survives ``close``."""
    cfg = dataclasses.replace(TINY, num_clients=2, client_feature_sizes=(8, 8))
    batch, M = 16, 2
    s = _mlp(cfg, batch=batch)
    _, tg_s, sg_s, _ = jax_protocol.protocol_step(
        jax_towers.mlp_tower_apply, jax_towers.mlp_tower_apply, s["jloss"],
        s["jparams"]["towers"], s["jparams"]["server"], s["jfeats"],
        jnp.asarray(s["y"]), cfg.merge, compress="topk",
        topk_fraction=FRACTION)
    np_params = jax.tree_util.tree_map(np.asarray, s["jparams"])
    specs = [WorkerSpec(build_mlp_worker, dict(
        cfg=cfg, params=np_params, batch=batch, microbatches=M,
        features=s["x"][None], compress="topk", topk_fraction=FRACTION,
        device="cpu")) for _ in range(cfg.num_clients)]
    with MultiprocTransport(specs, device="cpu") as tr:
        res = Executor(tr, towers.mlp_tower_apply, s["loss"], cfg.merge,
                       microbatches=M, compress="topk",
                       topk_fraction=FRACTION).run_step(
            s["params"]["server"], torch.from_numpy(s["y"]), step=0)
    assert not any(p.is_alive() for p in tr._procs)
    _close((res.tower_grads, res.server_grads), (tg_s, sg_s), ATOL)
    _audit(res.ledger, cfg.num_clients, batch // M, cfg.cut_dim, M, "topk")
