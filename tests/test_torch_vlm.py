"""The vlm family (internvl2-26b) against the JAX package, at the reduced
size (2 layers, d_model 256, 4 q / 4 kv heads, 8 vision tokens; the
vision and the text tower one layer each, one server layer).

- The config and the parameter counts.
- ``forward`` at 1e-5, each modality dropped by ``live_mask``;
  ``init_cache`` -> ``prefill_vision`` -> ``decode_step`` against the JAX
  package's (logits and every cache at 1e-5: the text tower's cache
  starts writing at slot Sv and keeps slots below it at -1) and against
  the port's own forward at 2e-3; ``generate``'s reference quirk (no
  vision prefix) to the JAX package's tokens; ``forward(window=...)``
  over 2560 positions, past the 2048 threshold (the chunked path on the
  CPU); a bf16 tree through ``forward``; ``_require_arange`` taking one
  contiguous run of positions from any start and refusing a gap.
- The split program (``merge_fn``: the sequence concatenation, a live
  mask zeroing a segment) and ``protocol_step`` against the JAX
  package's, the ledger message for message; ``train_split`` over sim
  and inproc, 2 steps, and over multiproc, 1 step, against the JAX
  ``train_split``; the monolithic ``train``.

The JAX package's params carried across by ``interop``; its training
reference runs compiled (``tests/jax_compiled.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.models import backbone as jax_backbone
from repro.models import split_program as jax_split_program
from repro.serve.decode import generate as jax_generate
from repro.train.loop import train as jax_train
from repro.train.loop import train_split as jax_train_split
from repro_torch.configs.base import get_arch
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import attention, backbone, split_program
from repro_torch.serve import generate
from repro_torch.train.loop import train, train_split
from jax_compiled import compiled_reference
from test_torch_moe import _one_torch_thread  # noqa: F401

ARCH = "internvl2-26b"
TOL = dict(rtol=1e-5, atol=1e-5)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_decode_equiv.py's
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# the text and the sequence (vision tokens included) of the training runs
B, S, BATCH, SEQ, STEPS = 2, 8, 4, 24, 2


@pytest.fixture(scope="module", autouse=True)
def _compiled_reference():
    with compiled_reference():
        yield


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jparams = jax_backbone.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    rng = np.random.default_rng(0)
    patches = (rng.standard_normal((B, cfg.vlm.num_vision_tokens,
                                    cfg.d_model)) * 0.5).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    # the JAX package's entry points compiled once each (eagerly every
    # layer scan compiles again at every call)
    jax_fns = dict(
        forward=jax.jit(lambda p, b, lm: jax_backbone.forward(
            p, b, jcfg, live_mask=lm)),
        decode=jax.jit(lambda p, c, t: jax_backbone.decode_step(p, c, t,
                                                                 jcfg)))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jax=jax_fns,
                patches=patches, tokens=tokens)


def _close(got, want, tol=TOL):
    got = to_numpy(got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


def _batch(setup, jax_side: bool) -> dict:
    batch = {"tokens": setup["tokens"], "patches": setup["patches"]}
    conv = jnp.asarray if jax_side else torch.as_tensor
    return {k: conv(v) for k, v in batch.items()}


def test_config_and_param_counts():
    """The sub-config and its reduction are the JAX package's, and so are
    the parameter counts, split and centralized, full and reduced (the
    full split model is 20,251,342,848 params)."""
    for reduced in (False, True):
        jcfg, cfg = jax_get_arch(ARCH), get_arch(ARCH)
        if reduced:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        assert cfg.vlm.__dict__ == jcfg.vlm.__dict__
        assert cfg.source == jcfg.source == "arXiv:2404.16821"
        assert backbone.param_count(cfg) == jax_backbone.param_count(jcfg)
        assert backbone.param_count(cfg.with_vertical(None)) == \
            jax_backbone.param_count(jcfg.with_vertical(None))
    assert backbone.param_count(get_arch(ARCH)) == 20_251_342_848


@pytest.mark.parametrize("live", [None, (1.0, 0.0), (0.0, 1.0)],
                         ids=["all", "drop-text", "drop-vision"])
def test_forward_matches_jax(setup, live):
    """``forward`` (the vision tower non-causal, the text tower from
    position Sv, their sequence concatenation, the server, the text
    positions' logits), every modality live and each one dropped."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    want, _ = setup["jax"]["forward"](
        setup["jparams"], _batch(setup, True),
        None if live is None else jnp.asarray(live))
    got, aux = backbone.forward(
        setup["params"], _batch(setup, False), cfg,
        live_mask=None if live is None else torch.tensor(live))
    assert got.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    _close(got, want)


def test_vision_prefill_and_decode_match_jax_and_forward(setup):
    """``init_cache`` -> ``prefill_vision`` -> 8 ``decode_step``s (the
    path that serves the family): caches and logits against the JAX
    package's at 1e-5 (the text tower's positions keep slots below Sv at
    -1), the decoded logits against the port's own forward at 2e-3."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    Sv = cfg.vlm.num_vision_tokens
    jcache = jax_backbone.init_cache(jcfg, B, Sv + S)
    cache = backbone.init_cache(cfg, B, Sv + S, device="cpu")
    _close(cache, jcache)
    jcache = jax_backbone.prefill_vision(setup["jparams"], jcache,
                                         jnp.asarray(setup["patches"]), jcfg)
    cache = backbone.prefill_vision(setup["params"], cache,
                                    torch.as_tensor(setup["patches"]), cfg)
    _close(cache, jcache)
    outs = []
    for t in range(S):
        jlogits, jcache = setup["jax"]["decode"](
            setup["jparams"], jcache, jnp.asarray(setup["tokens"][:, t]))
        logits, cache = backbone.decode_step(
            setup["params"], cache, torch.as_tensor(setup["tokens"][:, t]),
            cfg)
        _close(logits, jlogits)
        outs.append(logits)
    _close(cache, jcache)
    assert (cache["text_tower_positions"][:Sv] == -1).all()
    full, _ = backbone.forward(setup["params"], _batch(setup, False), cfg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               **DECODE_TOL)


def test_generate_keeps_the_reference_quirk(setup):
    """``generate`` never runs the vision prefill, as the JAX package's
    does not: the text decodes without its prefix, to the JAX package's
    greedy tokens."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    prompts = setup["tokens"][:, :4]
    want = jax_generate(setup["jparams"], jcfg, jnp.asarray(prompts),
                        max_new_tokens=6)
    got = generate(setup["params"], cfg, prompts, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_windowed_forward_past_the_threshold_matches_jax(setup):
    """``forward(window=...)`` over 8 + 2552 = 2560 positions, past the
    2048 threshold: the server's chunked attention with the window, as
    the JAX package's, within 1e-5 (and apart from the unwindowed run)."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 2552)).astype(
        np.int32), "patches": setup["patches"][:1]}
    want, _ = jax_backbone.forward(
        setup["jparams"], {k: jnp.asarray(v) for k, v in batch.items()},
        jcfg, window=300)
    got, _ = backbone.forward(
        setup["params"], {k: torch.as_tensor(v) for k, v in batch.items()},
        cfg, window=300)
    _close(got, want)
    full, _ = backbone.forward(
        setup["params"], {k: torch.as_tensor(v) for k, v in batch.items()},
        cfg)
    assert float((full - got).abs().max()) > 1e-3


def test_bf16_forward_matches_jax(setup):
    """A bf16 tree (f32 patches cast to it) through ``forward``, within
    the bf16 tolerance of the JAX package's bf16 forward."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                setup["jparams"])
    tp = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16),
                                setup["params"])
    want, _ = setup["jax"]["forward"](jp, _batch(setup, True), None)
    got, _ = backbone.forward(tp, _batch(setup, False), cfg)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float(), want.astype(jnp.float32), BF16_TOL)


@pytest.mark.parametrize("start", [0, 8, 1024])
def test_require_arange_takes_a_contiguous_run(start):
    """The flash kernel's causal mask is by row index, which equals the
    position mask for one contiguous run of positions: ``start +
    arange(S)`` is taken (the vlm text tower runs at ``Sv + arange(S)``),
    a gap or another length is refused by name."""
    S = 3072
    attention._require_arange(start + torch.arange(S), S)
    gap = start + torch.arange(S)
    gap[S // 2:] += 1
    for bad in (gap, start + torch.arange(S - 1), (start + torch.arange(S))
                .flip(0)):
        with pytest.raises(NotImplementedError, match="contiguous run"):
            attention._require_arange(bad, S)


def test_program_and_protocol_step_match_jax(setup):
    """The split program: exactly two clients, its shape flags and
    ``merge_fn`` (a live mask zeroing a segment, then the concatenation
    along the sequence), each modality tower, serving refused with the
    reference's words, the towers' own storage, and ``protocol_step``
    (loss, grads, the ledger message for message) against the JAX
    package's.  The port's text tower holds the input table alone (the
    JAX package's also holds the unused ``unembed``)."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jprog = jax_split_program.get_program(jcfg)
    prog = split_program.get_program(cfg)
    with pytest.raises(ValueError, match="exactly two"):
        split_program.get_program(cfg.with_vertical(dataclasses.replace(
            cfg.vertical, num_clients=3)))
    kw = prog.executor_kwargs
    assert kw["merge_fn"] is not None and not kw["server_takes_batch"] \
        and not kw["server_aux"] and prog.per_client_towers
    cuts = [torch.ones(2, 3, 4), 2 * torch.ones(2, 5, 4)]
    merged = prog.merge_fn(cuts, torch.tensor([1.0, 0.0]))
    want = jprog.merge_fn([jnp.asarray(c.numpy()) for c in cuts],
                          jnp.asarray([1.0, 0.0]))
    _close(merged, want)
    for fns, args in (("tower_serve_fns", (0,)), ("server_serve_fns", ())):
        with pytest.raises(NotImplementedError) as got:
            getattr(prog, fns)(*args)
        with pytest.raises(NotImplementedError) as want:
            getattr(jprog, fns)(*args)
        assert str(got.value) == str(want.value)
    # the training runs' step-0 batch: the JAX package's compiled server
    # and towers are differentiated at these shapes once
    jb = next(iter(JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0)))
    jtowers, jserver = jprog.partition(setup["jparams"])
    towers, server = prog.partition(setup["params"])
    jtowers[1] = {"embed": {"table": jtowers[1]["embed"]["table"]},
                  "blocks": jtowers[1]["blocks"]}
    _close(towers, jtowers)
    jfeats, feats = jprog.features(jb), prog.features(jb, "cpu")
    for k in range(2):
        _close(prog.tower_fwd(k)(towers[k], feats[k]),
               jprog.tower_fwd(k)(jtowers[k], jfeats[k]))
    jloss, jtg, jsg, jledger = jprog.protocol_step(
        jtowers, jserver, jfeats, jprog.batch_ctx(jb))
    loss, tg, sg, ledger = prog.protocol_step(
        towers, server, feats, prog.batch_ctx(jb, "cpu"))
    _close(loss, jloss)
    _close(tg, jtg)
    _close(sg, jsg)

    def messages(led):
        return sorted((m.sender, m.receiver, m.tag, m.num_bytes)
                      for m in led.messages)

    assert messages(ledger) == messages(jledger)


@pytest.fixture(scope="module")
def jax_run(setup):
    out, metrics, _ = jax_train_split(
        setup["jcfg"], JaxLMBatchLoader(setup["jcfg"], BATCH, SEQ, seed=0),
        steps=STEPS, batch=BATCH, seq=SEQ, transport="inproc",
        verify_step0=False, print_fn=lambda *a: None)
    towers = out["towers"]
    # the port's text tower holds the input table alone
    towers[1] = {"embed": {"table": towers[1]["embed"]["table"]},
                 "blocks": towers[1]["blocks"]}
    return out, metrics.losses


@pytest.mark.parametrize("transport", ["sim", "inproc"])
def test_train_split_matches_jax(setup, jax_run, transport):
    """Two serial steps through the Executor's ``merge_fn`` path (the
    cuts of 8 vision and 16 text positions concatenated, the jacobian
    split back by segment) against the JAX ``train_split``: losses,
    towers and server within 1e-4, step 0 verified in the run."""
    cfg = setup["cfg"]
    jout, jlosses = jax_run
    lines = []
    out, metrics, report = train_split(
        cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0), steps=STEPS,
        batch=BATCH, seq=SEQ, transport=transport, device="cpu",
        params=setup["params"], print_fn=lines.append)
    np.testing.assert_allclose(metrics.losses, jlosses, **RUN_TOL)
    assert metrics.step0_max_dgrad is not None and \
        metrics.step0_max_dgrad <= 1e-5
    assert any("step-0 verification" in line for line in lines)
    _close(out["towers"], jout["towers"], RUN_TOL)
    _close(out["server"], jout["server"], RUN_TOL)
    # the per-client cut figure is the mean of the two segments'
    assert report.cut_bytes_per_client == 4 * BATCH * SEQ * cfg.d_model // 2
    _close(setup["params"], setup["jparams"], dict(rtol=0, atol=0))


def test_train_split_multiproc_and_train_match_jax(setup, jax_run,
                                                   monkeypatch):
    """One step over a spawned process per modality (each regenerates its
    patches or tokens from the loader's seed) against the JAX run's first
    loss; two monolithic ``train`` steps against the JAX ``train``."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    _, jlosses = jax_run
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned children's
    _, metrics, _ = train_split(
        cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0), steps=1, batch=BATCH,
        seq=SEQ, transport="multiproc", device="cpu",
        params=setup["params"], print_fn=lambda *a: None)
    np.testing.assert_allclose(metrics.losses, jlosses[:1], **RUN_TOL)
    assert metrics.step0_max_dgrad <= 1e-5
    kw = dict(steps=STEPS, print_fn=lambda *a: None)
    jparams, jmetrics = jax_train(
        jcfg, JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0), **kw)
    got, metrics = train(cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0),
                         device="cpu", params=setup["params"], **kw)
    np.testing.assert_allclose(metrics.losses, jmetrics.losses, **RUN_TOL)
    _close(got, jparams, RUN_TOL)
