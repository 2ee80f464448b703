"""Secure aggregation on the port's execution path against the JAX package
(the twin of ``tests/test_secure_exec.py`` and ``tests/test_secure_agg.py``).

- The DH arithmetic is the JAX package's integer for integer, symmetric
  per pair; the port's masks (its own PRG: torch cannot reproduce
  threefry) cancel in the sum within ``cancellation_bound``, are fresh per
  round, and the JAX package's bound is the port's.
- ``distance_correlation``, ``leakage_penalty``, ``measure_split_leakage``
  and a NoPeek train step against ``repro.core.leakage``.
- The secure Executor (K = 3 MLP over sim and inproc, sum and avg, M = 2)
  against the JAX package's PLAIN ``protocol_step``:
  the masked sum role 0 observes within ``cancellation_bound`` of the raw
  sum, losses and gradients at 1e-3 (the JAX package's masked-verify
  tolerance); ``keyx_*`` and ``masked_cut[k]`` bytes equal
  ``costs.key_exchange_bytes`` / ``masked_cut_bytes`` exactly.
- Role 0's observations are blinded and carry no more raw structure than
  independent noise (dCor); rounds are fresh per step and microbatch; a
  recycled step id is refused by the Executor and by the worker; a
  federation drawing masks on two device types is refused.
- The rejections, with the JAX package's words; ``train_split`` secure
  over threads (reduced smollm-360m) verifies step 0 in-run against the
  unmasked serial step; one multiproc loopback (K = 2) carries the
  521-bit public values across processes.

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

from repro.core import leakage as jax_leakage
from repro.core import protocol as jax_protocol
from repro.core import secure_agg as jax_secure
from repro.core import split_model as jax_split_model
from repro.core import towers as jax_towers
from repro.optim import SGD as JaxSGD
from repro.runtime.executor import Executor as JaxExecutor
from repro.transport import SimTransport as JaxSimTransport
from repro_torch.configs.base import get_arch
from repro_torch.configs.vertical_mlp import MLPSplitConfig
from repro_torch.core import compat, costs, leakage, secure_agg, split_model
from repro_torch.core import towers
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.optim import SGD
from repro_torch.runtime.executor import Executor
from repro_torch.train.loop import train_split
from repro_torch.transport import (InprocTransport, MultiprocTransport,
                                   SimTransport, TowerWorker, WorkerSpec,
                                   build_mlp_worker)

TINY = MLPSplitConfig(
    name="secure_tiny", input_dim=16, num_classes=2, num_clients=3,
    client_feature_sizes=(6, 5, 5), tower_hidden=(16,), cut_dim=8,
    server_hidden=(16,), merge="avg")
TRANSPORTS = {"sim": SimTransport, "inproc": InprocTransport}
MASKED_ATOL = 1e-3


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


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------

def test_dh_matches_jax_and_is_symmetric():
    """The group, the key agreement and the bound are the JAX package's;
    each pair derives one seed from both ends."""
    assert (secure_agg.DH_PRIME, secure_agg.DH_GENERATOR,
            secure_agg.KEYX_GROUP_BYTES) == (
        jax_secure.DH_PRIME, jax_secure.DH_GENERATOR,
        jax_secure.KEYX_GROUP_BYTES)
    (a, pa), (b, pb) = secure_agg.dh_keypair(), secure_agg.dh_keypair()
    assert pa == pow(jax_secure.DH_GENERATOR, a, jax_secure.DH_PRIME)
    shared = secure_agg.dh_shared(a, pb)
    assert shared == secure_agg.dh_shared(b, pa) == \
        jax_secure.dh_shared(a, pb)
    assert secure_agg.seed_from_shared(shared) == \
        secure_agg.seed_from_shared(secure_agg.dh_shared(b, pa))
    assert 0 <= secure_agg.seed_from_shared(shared) < 2 ** 63
    with pytest.raises(ValueError, match="outside the group"):
        secure_agg.dh_shared(a, 1)
    assert secure_agg.pair_seed(3, 1, 2, 5) == secure_agg.pair_seed(3, 2, 1,
                                                                    5)
    for k, scale, mag in ((2, 1.0, 1.0), (4, 10.0, 3.0), (6, 0.5, 100.0)):
        assert secure_agg.cancellation_bound(k, scale, mag) == \
            jax_secure.cancellation_bound(k, scale, mag)


@pytest.mark.parametrize("k,d,seed", [(2, 1, 0), (3, 16, 5), (4, 64, 11),
                                      (6, 33, 77)])
def test_masks_cancel_within_bound(k, d, seed):
    """The centralized protocol: the masked sum is the raw sum within the
    bound (checked inside ``secure_sum`` too), every masked payload is far
    from its raw one, and the next round draws other masks."""
    payloads = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (k, 8, d)).astype(np.float32))
    agg, masked = secure_agg.secure_sum(payloads, base_seed=seed,
                                        round_idx=0)
    bound = secure_agg.cancellation_bound(
        k, 1.0, max(float(payloads.abs().max()), 1.0))
    assert float((agg - payloads.sum(0)).abs().max()) <= bound
    assert float((masked - payloads).abs().mean()) > 0.3
    _, masked1 = secure_agg.secure_sum(payloads, base_seed=seed,
                                       round_idx=1)
    assert float((masked1 - masked).abs().mean()) > 0.3


def test_dh_derived_masks_cancel_and_mismatched_rounds_do_not():
    """Masks from DH-derived pair seeds cancel like the centralized ones;
    the same masks drawn for different rounds leave garbage."""
    K, shape = 3, (4, 16)
    keys = [secure_agg.dh_keypair() for _ in range(K)]
    pubs = {i: p for i, (_, p) in enumerate(keys)}
    pair_keys = [{j: secure_agg.seed_from_shared(
        secure_agg.dh_shared(keys[i][0], pubs[j])) for j in pubs if j != i}
        for i in range(K)]
    raw = torch.randn((K,) + shape, generator=torch.Generator().manual_seed(0))
    masked = torch.stack([secure_agg.mask_payload_with_keys(
        raw[i], pair_keys[i], i, round_idx=7) for i in range(K)])
    bound = secure_agg.cancellation_bound(K, 1.0, float(raw.abs().max()))
    assert float((masked.sum(0) - raw.sum(0)).abs().max()) <= bound
    skewed = masked.clone()
    skewed[0] = secure_agg.mask_payload_with_keys(raw[0], pair_keys[0], 0,
                                                  round_idx=8)
    assert float((skewed.sum(0) - raw.sum(0)).abs().max()) > 100 * bound


# ---------------------------------------------------------------------------
# the leakage audit
# ---------------------------------------------------------------------------

def test_leakage_matches_jax():
    """dCor, the NoPeek penalty, the per-client audit and one NoPeek step
    (SGD) against ``repro.core.leakage``."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 5)).astype(np.float32)
    z = np.tanh(x @ rng.standard_normal((5, 3)).astype(np.float32))
    for a, b in ((x, z), (x, rng.standard_normal((32, 4)).astype(
            np.float32)), (x, x)):
        np.testing.assert_allclose(
            float(leakage.distance_correlation(torch.from_numpy(a),
                                               torch.from_numpy(b))),
            float(jax_leakage.distance_correlation(a, b)), atol=1e-5)
    cfg = TINY
    s = _mlp(cfg, batch=32)
    cuts = torch.stack([towers.mlp_tower_apply(s["params"]["towers"][k],
                                               s["feats"][k])
                        for k in range(cfg.num_clients)])
    np.testing.assert_allclose(
        float(leakage.leakage_penalty(s["feats"], cuts)),
        float(jax_leakage.leakage_penalty(s["jfeats"],
                                          jnp.asarray(cuts.numpy()))),
        atol=1e-5)
    np.testing.assert_allclose(
        leakage.measure_split_leakage(s["params"], cfg,
                                      torch.from_numpy(s["x"])),
        jax_leakage.measure_split_leakage(s["jparams"], cfg,
                                          jnp.asarray(s["x"])), atol=1e-5)
    jstep = jax_leakage.make_nopeek_train_step(cfg, JaxSGD(0.1))
    step = leakage.make_nopeek_train_step(cfg, SGD(0.1))
    jp, _, jl, jt, jk = jstep(s["jparams"], JaxSGD(0.1).init(s["jparams"]),
                              jnp.asarray(s["x"]), jnp.asarray(s["y"]))
    p, _, l, t, k = step(s["params"], SGD(0.1).init(s["params"]),
                         torch.from_numpy(s["x"]), torch.from_numpy(s["y"]))
    np.testing.assert_allclose([float(l), float(t), float(k)],
                               [float(jl), float(jt), float(jk)], atol=1e-5)
    _close(p, jp, 1e-5)


# ---------------------------------------------------------------------------
# the secure Executor against the JAX package's plain step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("merge", ["avg", "sum"])
def test_secure_executor_matches_jax_plain_mlp(merge, transport):
    """Masked M = 2 execution against the JAX package's unmasked serial
    step; the masked sum role 0 saw within ``cancellation_bound``; keyx and
    masked bytes exactly the byte models'."""
    cfg, M, K = dataclasses.replace(TINY, merge=merge), 2, 3
    s = _mlp(cfg)
    loss_s, tg_s, sg_s, led_s = jax_protocol.protocol_step(
        jax_towers.mlp_tower_apply, jax_towers.mlp_tower_apply, s["jloss"],
        s["jparams"]["towers"], s["jparams"]["server"], s["jfeats"],
        jnp.asarray(s["y"]), merge)
    workers = [TowerWorker(k, towers.mlp_tower_apply,
                           s["params"]["towers"][k]) for k in range(K)]
    tr = (RecordingSimTransport if transport == "sim" else
          InprocTransport)(workers)
    try:
        ex = Executor(tr, towers.mlp_tower_apply, s["loss"], merge,
                      microbatches=M, secure_agg=True)
        keyx = ex.setup_secure()
        res = ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                          features=s["feats"])
    finally:
        tr.close()
    np.testing.assert_allclose(float(res.loss), float(loss_s),
                               atol=MASKED_ATOL)
    _close((res.tower_grads, res.server_grads), (tg_s, sg_s), MASKED_ATOL)
    want = costs.key_exchange_bytes(K)
    for k in range(K):
        assert keyx.bytes_with_tag(f"keyx_pub[{k}]") == \
            want["pub_bytes_per_client"]
        assert keyx.bytes_with_tag(f"keyx_bcast[{k}]") == \
            want["bcast_bytes_per_client"]
        assert res.ledger.bytes_with_tag(f"masked_cut[{k}]") == \
            M * costs.masked_cut_bytes(16 // M, cfg.cut_dim) == \
            led_s.bytes_with_tag(f"cut[{k}]")
        assert res.ledger.bytes_with_tag(f"cut[{k}]") == 0
    assert keyx.total() == want["total"] == \
        sum(jax_secure.KEYX_GROUP_BYTES * (1 + K) for _ in range(K))
    if transport == "sim":
        for m in range(M):
            rows = slice(m * 8, (m + 1) * 8)
            raw = torch.stack([towers.mlp_tower_apply(
                s["params"]["towers"][k], s["feats"][k][rows])
                for k in range(K)])
            seen = torch.stack([tr.observed[(0, m, k)] for k in range(K)])
            bound = secure_agg.cancellation_bound(
                K, 1.0, max(float(raw.abs().max()), 1.0))
            assert float((seen.sum(0) - raw.sum(0)).abs().max()) <= bound


# ---------------------------------------------------------------------------
# privacy audits at role 0's observation surface
# ---------------------------------------------------------------------------

def test_role0_observations_are_masked_and_leak_less():
    """What role 0 drains under secure aggregation is far from the raw cut
    and carries no more raw-feature structure (dCor) than independent
    noise, where the raw cut carries much more."""
    cfg = TINY
    s = _mlp(cfg, batch=64)
    tr = RecordingSimTransport([
        TowerWorker(k, towers.mlp_tower_apply, s["params"]["towers"][k])
        for k in range(cfg.num_clients)])
    Executor(tr, towers.mlp_tower_apply, s["loss"], cfg.merge,
             secure_agg=True, secure_scale=10.0).run_step(
        s["params"]["server"], torch.from_numpy(s["y"]),
        features=s["feats"])
    for k in range(cfg.num_clients):
        raw = towers.mlp_tower_apply(s["params"]["towers"][k], s["feats"][k])
        seen = tr.observed[(0, 0, k)]
        assert float((seen - raw).abs().mean()) > 1.0
        noise = torch.randn(raw.shape,
                            generator=torch.Generator().manual_seed(100 + k))
        baseline = float(leakage.distance_correlation(s["feats"][k], noise))
        dcor_raw = float(leakage.distance_correlation(s["feats"][k], raw))
        dcor_seen = float(leakage.distance_correlation(s["feats"][k], seen))
        assert dcor_raw > baseline + 0.15
        assert dcor_seen < dcor_raw - 0.15
        assert dcor_seen < baseline + 0.1


def test_rounds_are_fresh_and_a_recycled_step_is_refused():
    """Identical features, params and microbatches over two steps: every
    uplink differs from every other (masks never reused).  Re-running step
    0 is refused by the Executor and, independently, by the worker."""
    cfg = TINY
    s = _mlp(cfg)
    feats = [torch.cat([f[:8], f[:8]]) for f in s["feats"]]
    workers = [TowerWorker(k, towers.mlp_tower_apply,
                           s["params"]["towers"][k])
               for k in range(cfg.num_clients)]
    tr = RecordingSimTransport(workers)
    ex = Executor(tr, towers.mlp_tower_apply, s["loss"], cfg.merge,
                  microbatches=2, secure_agg=True)
    for step in range(2):
        ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                    step=step, features=feats, collect_grads=False)
    for k in range(cfg.num_clients):
        views = [tr.observed[(st, m, k)] for st in (0, 1) for m in (0, 1)]
        for i in range(4):
            for j in range(i + 1, 4):
                assert float((views[i] - views[j]).abs().mean()) > 0.5
    with pytest.raises(ValueError, match="strictly increasing"):
        ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                    step=1, features=feats, collect_grads=False)
    with pytest.raises(ValueError, match="round .* already used"):
        workers[0].handle({"op": "forward", "step": 0, "mb": 0,
                           "feats": feats[0][:8]})
    assert workers[0]._dh_secret is None  # dropped once the keys exist


def test_mixed_device_federation_is_refused():
    """CPU and CUDA generators draw different noise from one seed: a key
    exchange between workers that mask on two device types is refused
    before any seed is derived."""
    cfg = TINY
    s = _mlp(cfg)
    workers = [TowerWorker(k, towers.mlp_tower_apply,
                           s["params"]["towers"][k])
               for k in range(cfg.num_clients)]
    workers[2].device = torch.device("cuda")  # reported, never touched
    ex = Executor(SimTransport(workers), towers.mlp_tower_apply, s["loss"],
                  cfg.merge, secure_agg=True)
    with pytest.raises(RuntimeError, match="one device type"):
        ex.setup_secure()
    assert all(w._secure is None for w in workers)


def test_unsupported_combinations_raise_with_the_jax_words():
    """Executor and config reject as the JAX package's do; setup on a
    plain Executor is refused."""
    cases = [
        dict(merge="max", secure_agg=True),
        dict(merge="avg", mode="nowait", secure_agg=True),
        dict(merge="avg", drop_policy="neutral", secure_agg=True),
    ]
    for kw in cases:
        kw = dict(kw)
        merge = kw.pop("merge")
        with pytest.raises(ValueError) as want:
            JaxExecutor(JaxSimTransport([]), None, None, merge, **kw)
        with pytest.raises(compat.CompatError) as got:
            Executor(SimTransport([]), None, None, merge, **kw)
        assert str(got.value) == str(want.value)
    from repro.configs.base import VerticalConfig as JaxVerticalConfig
    from repro_torch.configs.base import VerticalConfig

    with pytest.raises(ValueError) as want:
        JaxVerticalConfig(merge="mul", secure_aggregation=True)
    with pytest.raises(compat.CompatError) as got:
        VerticalConfig(merge="mul", secure_aggregation=True)
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="non-secure Executor"):
        Executor(SimTransport([TowerWorker(0, None, {})]), None, None,
                 "avg").setup_secure()
    cfg = get_arch("smollm-360m").reduced()
    cfg = cfg.with_vertical(dataclasses.replace(cfg.vertical,
                                                secure_aggregation=True))
    with pytest.raises(compat.CompatError, match="barrier execution"):
        train_split(cfg, LMBatchLoader(cfg, 2, 16), steps=1, batch=2,
                    seq=16, runtime="nowait", device="cpu")


def test_train_split_secure_verifies_step0():
    """Split training under secure aggregation over threads: the key
    exchange runs once, step 0's masked merge is verified in-run against
    the unmasked serial step, and role 0's masked sum within the bound."""
    cfg = get_arch("smollm-360m").reduced()
    cfg = cfg.with_vertical(dataclasses.replace(cfg.vertical,
                                                secure_aggregation=True))
    lines = []
    _, metrics, _ = train_split(
        cfg, LMBatchLoader(cfg, 2, 16), steps=2, batch=2, seq=16,
        device="cpu", print_fn=lines.append)
    assert any("key exchange complete" in ln for ln in lines)
    assert any("masked-merge verification" in ln and "OK" in ln
               for ln in lines)
    assert metrics.step0_max_dgrad <= MASKED_ATOL
    assert metrics.step0_mask_residue <= metrics.step0_mask_bound
    assert metrics.keyx_ledger.total() == \
        costs.key_exchange_bytes(cfg.vertical.num_clients)["total"]
    assert all(np.isfinite(metrics.losses))


def test_multiproc_secure_loopback_matches_and_reconciles():
    """The key exchange's 521-bit public values and the masked uplinks
    cross two spawned processes; the gradients match the JAX package's
    unmasked serial step at 1e-3 and the bytes reconcile."""
    cfg = dataclasses.replace(TINY, num_clients=2,
                              client_feature_sizes=(8, 8))
    batch, M = 16, 2
    s = _mlp(cfg, batch=batch)
    loss_s, tg_s, sg_s, _ = jax_protocol.protocol_step(
        jax_towers.mlp_tower_apply, jax_towers.mlp_tower_apply, s["jloss"],
        s["jparams"]["towers"], s["jparams"]["server"], s["jfeats"],
        jnp.asarray(s["y"]), cfg.merge)
    np_params = jax.tree_util.tree_map(np.asarray, s["jparams"])
    specs = [WorkerSpec(build_mlp_worker, dict(
        cfg=cfg, params=np_params, batch=batch, microbatches=M,
        features=s["x"][None], device="cpu"))
        for _ in range(cfg.num_clients)]
    with MultiprocTransport(specs, device="cpu") as tr:
        ex = Executor(tr, towers.mlp_tower_apply, s["loss"], cfg.merge,
                      microbatches=M, secure_agg=True)
        keyx = ex.setup_secure()
        res = ex.run_step(s["params"]["server"], torch.from_numpy(s["y"]),
                          step=0)
    assert not any(p.is_alive() for p in tr._procs)
    np.testing.assert_allclose(float(res.loss), float(loss_s),
                               atol=MASKED_ATOL)
    _close((res.tower_grads, res.server_grads), (tg_s, sg_s), MASKED_ATOL)
    assert keyx.total() == costs.key_exchange_bytes(2)["total"]
    assert res.ledger.bytes_with_tag("masked_cut[0]") == \
        M * costs.masked_cut_bytes(batch // M, cfg.cut_dim)
