"""The audio family (whisper-tiny) against the JAX package, at the reduced
size (2 decoder layers, d_model 256, K = 2 mel-band towers of one layer,
one server encoder layer over 16 frames).

- The config and the parameter counts; ``layernorm``, ``gelu_mlp`` and
  the sinusoids against ``repro.models.layers`` (f32 and bf16; over
  whisper's 1500 frames within two f32 spacings of the largest angle).
- ``forward`` and ``encode_audio`` at 1e-5, each client dropped by
  ``live_mask``, and with the towers taking the whole encoder (the
  server's ``encoder`` None); ``prefill_cross_attention`` plus 8 ``decode_step``s
  against the JAX package's (logits and every cache at 1e-5) and against
  the port's own forward at 2e-3 (``tests/test_decode_equiv.py``'s
  rule); ``generate``'s reference quirk (no cross prefill: the decoder
  attends to zero cross caches) to the JAX package's tokens; a bf16 tree
  through ``forward`` held to the JAX package's bf16 forward.
- The split program (``server_takes_batch``, each client's columns of
  the full-width sinusoid) against the JAX package's and
  ``protocol_step``'s ledger against its step schedule, message for
  message; ``train_split`` over sim
  and inproc, 2 steps, and over multiproc, 1 step, against the JAX
  ``train_split``.

The JAX package's params carried across by ``interop``; its training
reference runs compiled (``tests/jax_compiled.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.models import backbone as jax_backbone
from repro.models import layers as jax_layers
from repro.models import split_program as jax_split_program
from repro.serve.decode import generate as jax_generate
from repro.train.loop import train_split as jax_train_split
from repro_torch.configs.base import get_arch
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.models import backbone, layers, split_program
from repro_torch.serve import generate
from repro_torch.train.loop import train_split
from jax_compiled import compiled_reference
from test_torch_moe import _one_torch_thread  # noqa: F401

ARCH = "whisper-tiny"
TOL = dict(rtol=1e-5, atol=1e-5)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_decode_equiv.py's
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
B, S, BATCH, SEQ, STEPS = 2, 8, 4, 16, 2


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
    frames = (rng.standard_normal((B, cfg.encdec.encoder_seq_len,
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
                frames=frames, tokens=tokens)


def _close(got, want, tol=TOL):
    got = to_numpy(got)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)


def _batch(setup, jax_side: bool) -> dict:
    batch = {"tokens": setup["tokens"], "frames": setup["frames"]}
    conv = jnp.asarray if jax_side else torch.as_tensor
    return {k: conv(v) for k, v in batch.items()}


def test_config_and_param_counts():
    """The sub-config and its reduction are the JAX package's; the
    parameter counts of the full and the reduced config are too (the
    full one with the towers taking one of the four encoder layers)."""
    for reduced in (False, True):
        jcfg, cfg = jax_get_arch(ARCH), get_arch(ARCH)
        if reduced:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        assert cfg.encdec.__dict__ == jcfg.encdec.__dict__
        assert cfg.source == jcfg.source == "arXiv:2212.04356"
        assert backbone.param_count(cfg) == jax_backbone.param_count(jcfg)
        assert backbone.param_count(cfg.with_vertical(None)) == \
            jax_backbone.param_count(jcfg.with_vertical(None))
    assert backbone.param_count(get_arch(ARCH)) == 55_716_096


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layers_match_jax(dtype):
    """``layernorm`` (biased variance in f32), the GELU MLP (tanh form,
    with biases) and the sinusoids, whole and at a position."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    tol = TOL if dtype == torch.float32 else BF16_TOL
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    ln = {"scale": rng.standard_normal(64).astype(np.float32),
          "bias": rng.standard_normal(64).astype(np.float32)}
    mlp = {"w_in": rng.standard_normal((64, 96)).astype(np.float32) / 8,
           "b_in": rng.standard_normal(96).astype(np.float32),
           "w_out": rng.standard_normal((96, 64)).astype(np.float32) / 10,
           "b_out": rng.standard_normal(64).astype(np.float32)}

    def both(tree):
        return (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype),
                                       tree),
                jax.tree_util.tree_map(lambda a: torch.tensor(a).to(dtype),
                                       tree))

    (jx, tx), (jln, tln), (jmlp, tmlp) = both(x), both(ln), both(mlp)
    got = layers.layernorm(tln, tx)
    assert got.dtype == dtype
    _close(got, jax_layers.layernorm(jln, jx).astype(jnp.float32), tol)
    _close(layers.gelu_mlp(tmlp, tx),
           jax_layers.gelu_mlp(jmlp, jx).astype(jnp.float32), tol)
    for d in (64, 6, 2):
        _close(layers.sinusoidal_positions(37, d, dtype),
               jax_layers.sinusoidal_positions(37, d, jdtype).astype(
                   jnp.float32), tol)
        for pos in (0, 5, 36):
            _close(layers.sinusoidal_position_at(torch.tensor(pos), d,
                                                 dtype),
                   jax_layers.sinusoidal_position_at(pos, d, jdtype).astype(
                       jnp.float32), tol)
    # whisper's 1500 encoder frames: the two libraries' f32 sin and cos of
    # angles up to 1499 rad part by up to 1.2e-4, the spacing of f32 there
    # (3.1e-5 over the decoder's 448 positions); held at two spacings
    angle = dict(rtol=0, atol=2 * float(np.spacing(np.float32(1499))))
    if dtype == torch.float32:
        _close(layers.sinusoidal_positions(1500, 384),
               jax_layers.sinusoidal_positions(1500, 384), angle)
        _close(layers.sinusoidal_position_at(torch.tensor(1499), 384),
               jax_layers.sinusoidal_position_at(1499, 384), angle)
    init = layers.init_gelu_mlp(torch.Generator().manual_seed(0), 64, 96,
                                lead=(3,))
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        "w_in": (3, 64, 96), "b_in": (3, 96), "w_out": (3, 96, 64),
        "b_out": (3, 64)}
    assert not init["b_in"].any() and not init["b_out"].any()


@pytest.mark.parametrize("live", [None, (1.0, 0.0), (0.0, 1.0)],
                         ids=["all", "drop-1", "drop-0"])
def test_forward_matches_jax(setup, live):
    """``forward`` (encoder towers, server encoder, teacher-forced
    decoder with cross attention) and ``encode_audio``, every client live
    and each one dropped."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jlm = None if live is None else jnp.asarray(live)
    lm = None if live is None else torch.tensor(live)
    want, jaux = setup["jax"]["forward"](setup["jparams"],
                                         _batch(setup, True), jlm)
    got, aux = backbone.forward(setup["params"], _batch(setup, False), cfg,
                                live_mask=lm)
    _close(got, want)
    assert float(aux) == float(jaux) == 0.0
    _close(backbone.encode_audio(setup["params"],
                                 torch.as_tensor(setup["frames"]), cfg,
                                 live_mask=lm),
           jax_backbone.encode_audio(setup["jparams"],
                                     jnp.asarray(setup["frames"]), jcfg,
                                     live_mask=jlm))


def test_towers_taking_the_whole_encoder_match_jax(setup):
    """With as many tower layers as encoder layers the server keeps no
    encoder stack (``encoder`` None in both packages, carried across as
    None by ``interop``): the init's count and the forward match."""
    import dataclasses

    jcfg, cfg = (dataclasses.replace(c, encdec=dataclasses.replace(
        c.encdec, encoder_layers=1)) for c in (setup["jcfg"], setup["cfg"]))
    jparams = jax_backbone.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    assert jparams["encoder"] is None and params["encoder"] is None
    assert backbone.init_params(cfg, device="cpu")["encoder"] is None
    assert backbone.param_count(cfg) == jax_backbone.param_count(jcfg)
    want, _ = jax_backbone.forward(jparams, _batch(setup, True), jcfg)
    got, _ = backbone.forward(params, _batch(setup, False), cfg)
    _close(got, want)


def test_cross_prefill_and_decode_match_jax_and_forward(setup):
    """``init_cache`` -> ``prefill_cross_attention`` -> 8 ``decode_step``s
    (the path that serves the family): the caches and every step's logits
    against the JAX package's at 1e-5, and the decoded logits against the
    port's own teacher-forced forward at 2e-3."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jcache = jax_backbone.init_cache(jcfg, B, S)
    cache = backbone.init_cache(cfg, B, S, device="cpu")
    _close(cache, jcache)
    jcache = jax_backbone.prefill_cross_attention(
        setup["jparams"], jcache, jnp.asarray(setup["frames"]), jcfg)
    cache = backbone.prefill_cross_attention(
        setup["params"], cache, torch.as_tensor(setup["frames"]), cfg)
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
    full, _ = backbone.forward(setup["params"], _batch(setup, False), cfg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               **DECODE_TOL)


def test_generate_keeps_the_reference_quirk(setup):
    """``generate`` never runs the cross prefill, as the JAX package's
    does not: the decoder attends to zero cross caches, and the greedy
    tokens are the JAX package's."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    prompts = setup["tokens"][:, :4]
    want = jax_generate(setup["jparams"], jcfg, jnp.asarray(prompts),
                        max_new_tokens=6)
    got = generate(setup["params"], cfg, prompts, max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_forward_matches_jax(setup):
    """A bf16 tree (f32 frames cast to it, as ``encode_audio`` casts them)
    through ``forward``: bf16 logits within the bf16 tolerance of the JAX
    package's."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                setup["jparams"])
    tp = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16),
                                setup["params"])
    want, _ = setup["jax"]["forward"](jp, _batch(setup, True), None)
    got, _ = backbone.forward(tp, _batch(setup, False), cfg)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float(), want.astype(jnp.float32), BF16_TOL)


def test_program_and_protocol_step(setup):
    """The split program: its shape flags, each client's tower (its
    columns of the full-width sinusoid) against the JAX package's, its
    serving refused with the reference's words, and ``protocol_step``
    (role 0's server taking the batch's tokens) whose Ledger is the JAX
    package's step schedule message for message at its byte models.
    (Its gradients are held to the JAX package's through
    ``train_split`` below.)"""
    from repro.core import costs as jax_costs
    from repro.core import protocol as jax_protocol

    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jprog = jax_split_program.get_program(jcfg)
    prog = split_program.get_program(cfg)
    assert prog.executor_kwargs == dict(server_takes_batch=True,
                                        server_aux=False, merge_fn=None)
    assert prog.per_client_towers and jprog.per_client_towers
    for fns, args in (("tower_serve_fns", (0,)), ("server_serve_fns", ())):
        with pytest.raises(NotImplementedError) as got:
            getattr(prog, fns)(*args)
        with pytest.raises(NotImplementedError) as want:
            getattr(jprog, fns)(*args)
        assert str(got.value) == str(want.value)
    jb = next(iter(JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0)))
    jtowers, _ = jprog.partition(setup["jparams"])
    towers, server = prog.partition(setup["params"])
    jfeats, feats = jprog.features(jb), prog.features(jb, "cpu")
    for k in range(prog.num_clients):
        _close(prog.tower_fwd(k)(towers[k], feats[k]),
               jprog.tower_fwd(k)(jtowers[k], jfeats[k]))
    loss, tg, sg, ledger = prog.protocol_step(
        towers, server, feats, prog.batch_ctx(jb, "cpu"))
    assert np.isfinite(float(loss))
    sched = jax_protocol.step_schedule(prog.num_clients)
    cut = jax_costs.cut_bytes(BATCH * cfg.encdec.encoder_seq_len,
                              cfg.d_model)
    head = jax_costs.head_exchange_bytes(BATCH * SEQ, cfg.vocab_size)
    want = sorted([(m.sender, m.receiver, m.tag, cut)
                   for m in sched.cuts + sched.jacs] +
                  [(m.sender, m.receiver, m.tag, head)
                   for m in (sched.head_out, sched.head_jac)])
    assert sorted((m.sender, m.receiver, m.tag, m.num_bytes)
                  for m in ledger.messages) == want


@pytest.fixture(scope="module")
def jax_run(setup):
    out, metrics, _ = jax_train_split(
        setup["jcfg"], JaxLMBatchLoader(setup["jcfg"], BATCH, SEQ, seed=0),
        steps=STEPS, batch=BATCH, seq=SEQ, transport="inproc",
        verify_step0=False, print_fn=lambda *a: None)
    return out, metrics.losses


@pytest.mark.parametrize("transport", ["sim", "inproc"])
def test_train_split_matches_jax(setup, jax_run, transport):
    """Two serial steps through the Executor's ``server_takes_batch`` path
    (the decoder's tokens in role 0's batch context) against the JAX
    ``train_split``: losses, towers and server within 1e-4, step 0
    verified in the run against the serial ``protocol_step``."""
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
    assert report.cut_bytes_per_client == 4 * BATCH * \
        cfg.encdec.encoder_seq_len * cfg.d_model
    # the caller's tree is left as it was
    _close(setup["params"], setup["jparams"], dict(rtol=0, atol=0))


def test_train_split_multiproc_matches_jax(setup, jax_run, monkeypatch):
    """One step over a spawned process per feature holder (each
    regenerates its mel-band slice of the loader's frames from the seed)
    against the JAX run's first loss.  (The monolithic ``train`` of the
    modality families is held to the JAX package's in
    ``tests/test_torch_vlm.py``.)"""
    cfg = setup["cfg"]
    _, jlosses = jax_run
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned children's
    _, metrics, _ = train_split(
        cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0), steps=1, batch=BATCH,
        seq=SEQ, transport="multiproc", device="cpu",
        params=setup["params"], print_fn=lambda *a: None)
    np.testing.assert_allclose(metrics.losses, jlosses[:1], **RUN_TOL)
    assert metrics.step0_max_dgrad <= 1e-5
