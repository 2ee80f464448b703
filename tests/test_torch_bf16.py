"""bf16 parity of the two paths whose faults were repaired in the port
(ROADMAP.md, Queue 3, resolved): the paper's MLP with a bf16 param tree
(``core/towers.mlp_tower_apply`` now multiplies through
``layers.matmul``), and bf16 ssm generation (``models/mamba
.mamba_decode_step`` now promotes its conv window product as
``jnp.einsum`` does, over the f32 cache that ``generate`` makes).

Inputs are the ones the faults were recorded with: the JAX package's
bf16 init (``PRNGKey(0)``) carried across by ``interop``, features from
``np.random.default_rng(0)``, prompts from ``default_rng(8)``.
Tolerances: 3e-2 on bf16 values (the repo's bf16 tolerance); greedy
tokens equal wherever the JAX package's top-2 logit gap exceeds 6e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import vertical_mlp as jax_configs
from repro.configs.base import get_arch as jax_get_arch
from repro.core import split_model as jax_split_model
from repro.core import towers as jax_towers
from repro.models import backbone as jax_backbone
from repro.runtime.executor import Executor as JaxExecutor
from repro.serve import decode as jax_decode
from repro.transport.base import SimTransport as JaxSimTransport
from repro.transport.base import TowerWorker as JaxTowerWorker
from repro_torch.configs.base import get_arch
from repro_torch.configs.vertical_mlp import FINANCIAL_PHRASEBANK
from repro_torch.core import split_model, towers
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.runtime.executor import Executor
from repro_torch.serve import generate
from repro_torch.transport import (SimTransport, TowerWorker,
                                   build_mlp_worker)
from jax_compiled import compiled_reference

BF16_TOL = dict(rtol=3e-2, atol=3e-2)
GAP = 6e-2


@pytest.fixture(scope="module", autouse=True)
def _compiled_reference():
    """The JAX package's init, towers and server compiled
    (``tests/jax_compiled.py``)."""
    with compiled_reference():
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol=BF16_TOL):
    g = jax.tree_util.tree_leaves(to_numpy(got))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(
            a, np.asarray(jnp.asarray(b).astype(jnp.float32)), **tol)


def _mlp(merge):
    cfg = dataclasses.replace(FINANCIAL_PHRASEBANK, merge=merge)
    jcfg = dataclasses.replace(jax_configs.FINANCIAL_PHRASEBANK, merge=merge)
    jparams = jax_split_model.init_split_mlp(jax.random.PRNGKey(0), jcfg,
                                             dtype=jnp.bfloat16)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    assert params["server"]["w0"].dtype == torch.bfloat16
    return cfg, jcfg, params, jparams


@pytest.mark.parametrize("merge", ["max", "avg", "concat"])
def test_split_forward_bf16_matches_jax(merge):
    """Fault 1: f32 features through a bf16 tree give f32 logits, as the
    JAX package's promotion does (the port raised before)."""
    cfg, jcfg, params, jparams = _mlp(merge)
    x = np.random.default_rng(0).standard_normal((8, 300)).astype(
        np.float32)
    want = jax_split_model.split_forward(jparams, jnp.asarray(x), jcfg)
    got = split_model.split_forward(params, torch.from_numpy(x), cfg)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == (8, 3)
    _close(got, want)
    own = split_model.init_split_mlp(None, cfg, dtype=torch.bfloat16,
                                     device="cpu")
    assert torch.isfinite(split_model.split_forward(
        own, torch.from_numpy(x), cfg)).all()


def test_mlp_executor_step_bf16_matches_jax():
    """Fault 1 on the Executor's path: ``build_mlp_worker`` runs the same
    tower function; one fused step at 2 microbatches, loss and every
    gradient within 3e-2 of the JAX package's."""
    cfg, jcfg, params, jparams = _mlp("max")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, cfg.input_dim)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, 16).astype(np.int32)
    xt = torch.from_numpy(x)
    workers = [build_mlp_worker(k, cfg=cfg, batch=16, microbatches=2,
                                params=params, features=lambda step: xt,
                                device="cpu")
               for k in range(cfg.num_clients)]
    ex = Executor(SimTransport(workers), towers.mlp_tower_apply,
                  lambda lg, lb: split_model.softmax_xent(
                      lg, lb, cfg.num_classes), cfg.merge, microbatches=2)
    res = ex.run_step(params["server"], torch.from_numpy(y))
    jfeats = [jnp.asarray(x[:, list(s.indices)])
              for s in jax_split_model.feature_slices(jcfg)]
    jex = JaxExecutor(
        JaxSimTransport([JaxTowerWorker(k, jax_towers.mlp_tower_apply,
                                        jparams["towers"][k])
                         for k in range(jcfg.num_clients)]),
        jax_towers.mlp_tower_apply,
        lambda lg, lb: jax_split_model.softmax_xent(lg, lb,
                                                    jcfg.num_classes),
        jcfg.merge, microbatches=2)
    jres = jex.run_step(jparams["server"], jnp.asarray(y), features=jfeats)
    _close(res.loss, jres.loss)
    _close((res.tower_grads, res.server_grads),
           (jres.tower_grads, jres.server_grads))
    assert res.tower_grads[0]["w0"].dtype == torch.bfloat16


def test_ssm_generate_bf16_matches_jax():
    """Fault 2: bf16 greedy generation of reduced mamba2-1.3b over the f32
    decode cache (the port raised at the first decode step).  Each row's
    tokens equal the JAX package's up to its first step whose top-2 logit
    gap is 6e-2 or less (past such a near-tie the two runs may part)."""
    jcfg, cfg = jax_get_arch("mamba2-1.3b").reduced(), \
        get_arch("mamba2-1.3b").reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    prompts = np.random.default_rng(8).integers(
        0, cfg.vocab_size, (3, 10)).astype(np.int32)
    new = 5
    want = np.asarray(jax_decode.generate(jparams, jcfg, jnp.asarray(prompts),
                                          max_new_tokens=new))
    got = generate(params, cfg, prompts, max_new_tokens=new)
    assert got.shape == (3, new)
    # the JAX package's logits at each generated position: its prompt and
    # its own tokens replayed through its decode step
    step = jax.jit(lambda p, c, t: jax_backbone.decode_step(p, c, t, jcfg))
    cache = jax_backbone.init_cache(jcfg, 3, 10 + new)
    seq = np.concatenate([prompts, want], axis=1)
    gaps = []
    for t in range(10 + new - 1):
        logits, cache = step(jparams, cache, jnp.asarray(seq[:, t]))
        if t >= 9:
            top2 = np.sort(np.asarray(logits.astype(jnp.float32)), -1)[:, -2:]
            gaps.append(top2[:, 1] - top2[:, 0])
    gaps = np.stack(gaps, axis=1)  # (3, new)
    held = 0
    for row in range(3):
        for t in range(new):
            if gaps[row, t] <= GAP:
                break
            assert int(got[row, t]) == int(want[row, t]), (row, t)
            held += 1
    assert held >= 5, gaps


# ---------------------------------------------------------------------------
# the bf16 entry points of the wire overlays (the monolithic train's:
# tests/test_torch_bf16_train.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_lm():
    jcfg, cfg = jax_get_arch("smollm-360m").reduced(), \
        get_arch("smollm-360m").reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    return jcfg, cfg, jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def test_train_split_bf16_int8_verifies_step0(bf16_lm):
    """``train_split`` of a bf16 tree under ``--compress int8`` at its entry
    point: step 0 verified in-run at ``STEP0_VERIFY_ATOL``, the params stay
    bf16, the uplinks ledger the codec's bytes (one code per element, the
    8-byte frame per vector)."""
    from repro_torch.core import costs
    from repro_torch.core.compression import STEP0_VERIFY_ATOL
    from repro_torch.data.loader import LMBatchLoader
    from repro_torch.train.loop import train_split

    _, cfg, _, params = bf16_lm
    cfg = cfg.with_vertical(dataclasses.replace(cfg.vertical,
                                                compression="int8"))
    out, metrics, _ = train_split(cfg, LMBatchLoader(cfg, 4, 16), steps=2,
                                  batch=4, seq=16, device="cpu",
                                  params=params, print_fn=lambda *a: None)
    assert metrics.step0_max_dgrad <= STEP0_VERIFY_ATOL
    assert all(np.isfinite(metrics.losses))
    assert {t.dtype for t in jax.tree_util.tree_leaves(out["server"])} == \
        {torch.bfloat16}
    assert metrics.ledgers[1].bytes_with_tag("compressed_cut[0]") == \
        costs.wire_bytes((4, 16, cfg.d_model), 2, "int8")


def test_train_split_bf16_secure_matches_jax(bf16_lm):
    """A bf16 tree under ``--secure-agg``: the masks widen each cut to f32,
    so role 0's server runs on an f32 merge where the plain serial step
    runs bf16 — in the JAX package as here.  The port's masked step equals
    the JAX package's masked step at 1e-3 (gradients and loss); against
    the plain bf16 step both differ past the 1e-3 of the in-run
    verification, which therefore refuses the run (ROADMAP.md, Queue 3,
    reference quirks); unverified, the run trains.  The masked steps are
    compared at the file's bf16 tolerance: the gradients are bf16."""
    from repro.models import split_program as jax_split_program
    from repro_torch.data.loader import LMBatchLoader
    from repro_torch.models import split_program
    from repro_torch.train.loop import train_split

    jcfg, cfg, jparams, params = bf16_lm
    batch = next(iter(LMBatchLoader(cfg, 4, 16)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jprog, prog = jax_split_program.get_program(jcfg), \
        split_program.get_program(cfg)
    jtow, jserv = jprog.partition(jparams)
    jfeats, jctx = jprog.features(jb), jprog.batch_ctx(jb)
    _, tg_p, sg_p, _ = jprog.protocol_step(jtow, jserv, jfeats, jctx)
    jres = JaxExecutor(JaxSimTransport([
        JaxTowerWorker(k, jprog.tower_fwd(k), jtow[k])
        for k in range(jprog.num_clients)]), jprog.server_fwd,
        jprog.loss_fn, jprog.merge, secure_agg=True).run_step(
        jserv, jctx, features=jfeats)
    tow, serv = prog.partition(params)
    res = Executor(SimTransport([
        TowerWorker(k, prog.tower_fwd(k), tow[k])
        for k in range(prog.num_clients)]), prog.server_fwd, prog.loss_fn,
        prog.merge, secure_agg=True).run_step(
        serv, prog.batch_ctx(batch, "cpu"),
        features=prog.features(batch, "cpu"))
    np.testing.assert_allclose(float(res.loss), float(jres.loss), atol=1e-3)
    _close((res.tower_grads, res.server_grads),
           (jres.tower_grads, jres.server_grads))

    def dev(grads):
        return max(float(np.max(np.abs(
            np.asarray(jnp.asarray(a).astype(jnp.float32))
            - np.asarray(b.astype(jnp.float32))))) for a, b in zip(
            jax.tree_util.tree_leaves(to_numpy(grads)),
            jax.tree_util.tree_leaves((tg_p, sg_p))))

    assert dev((jres.tower_grads, jres.server_grads)) > 1e-3
    assert dev((res.tower_grads, res.server_grads)) > 1e-3
    secure = cfg.with_vertical(dataclasses.replace(cfg.vertical,
                                                   secure_aggregation=True))
    with pytest.raises(RuntimeError, match="masked-merge gradients diverge"):
        train_split(secure, LMBatchLoader(secure, 4, 16), steps=1, batch=4,
                    seq=16, device="cpu", params=params,
                    print_fn=lambda *a: None)
    _, metrics, _ = train_split(
        secure, LMBatchLoader(secure, 4, 16), steps=2, batch=4, seq=16,
        device="cpu", params=params, verify_step0=False,
        print_fn=lambda *a: None)
    assert all(np.isfinite(metrics.losses))
    assert metrics.keyx_ledger.total() == 396
