"""The port's ssm family against the JAX package: the SSD chunk kernel's
plain version and host side, the Mamba2 block, and the full-sequence
forward, decode and greedy generation of reduced mamba2-1.3b, with the JAX
package's params carried across by ``interop``.  The CUDA chunk kernel's
arithmetic (3xTF32 products, the decay mask) and operand layout (tiles,
descriptors, fragments, rows past Q zero-filled) are modelled in numpy
and held to the Pallas kernel and to exact float64 products.

Inputs are made from a seed with numpy and fed to both packages; f32
throughout.  Tolerances are the JAX package's own: 3e-4 for the SSD chunk
kernel against its oracles (``tests/test_kernels.py``), 2e-3 for decode
against the forward (``tests/test_decode_equiv.py``).  Where the two
packages run the same algorithm and differ only in summation order, 1e-5
(the SSD scan, the block) and 1e-4 (logits, after a dozen stacked layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels import ssd_scan as jax_ssd
from repro.models import backbone as jax_backbone
from repro.models import mamba as jax_mamba
from repro.serve import decode as jax_decode
from repro_torch.configs.base import get_arch
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.models import backbone, mamba
from repro_torch.serve import generate
from wgmma_model import (CORE, _core_index, _fragments, _from_wgmma, _lanes,
                         _split, _tf32_product, _wgmma, _wgmma_b)

ARCH = "mamba2-1.3b"
KERNEL_TOL = dict(rtol=3e-4, atol=3e-4)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 activations: the repo's bf16 tolerance for attention (a couple of
# bf16 ulps at the logits' magnitude, after a dozen stacked layers)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# bf16 logits of the reduced model (|logit| < 4): 4 bf16 ulps at [2, 4)
BF16_LOGIT_TOL = dict(rtol=3e-2, atol=4 * 2.0 ** -6)
# the shapes of the JAX package's own SSD kernel tests: (S, P, N, chunk)
SSD_SHAPES = [(64, 16, 16, 16), (128, 32, 32, 32)]


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
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    return jcfg, cfg, jparams, params


def _close(got, want, tol):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **tol)


def _close_bf16(got, want, tol=BF16_TOL):
    """A bf16 (or f32) result against JAX's, in the same dtype, compared in
    f32."""
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _close(got.float(), np.asarray(want.astype(jnp.float32)), tol)


def _ssd_inputs(B, S, H, P, N, G=1, seed=0):
    """The JAX test's input distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) * 0.5))
    A = -np.exp(rng.standard_normal((H,)) * 0.3)
    Bm = rng.standard_normal((B, S, G, N)) * 0.3
    Cm = rng.standard_normal((B, S, G, N)) * 0.3
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(a) for a in arrays])


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# the chunk kernel's plain version and the host side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,Q,P,N", [(6, 16, 16, 16), (4, 32, 32, 32)])
def test_ssd_chunk_matches_jax_kernel_and_oracle(G, Q, P, N):
    """ref.ssd_chunk, batched over G chunks, against the Pallas kernel in
    interpret mode and against the JAX oracle vmapped."""
    rng = np.random.default_rng(G * Q)
    x = rng.standard_normal((G, Q, P)).astype(np.float32)
    a = -np.abs(rng.standard_normal((G, Q)) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((G, Q, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((G, Q, N)) * 0.3).astype(np.float32)
    jin, tin = _both([x, a, Bm, Cm])
    got = ref.ssd_chunk(*tin)
    pallas = jax_ssd.ssd_chunk_batch(*jin, interpret=True)
    oracle = jax.vmap(jax_ref.ssd_chunk)(*jin)
    for want in (pallas, oracle):
        for g, w in zip(got, want):
            _close(g, np.asarray(w).reshape(tuple(g.shape)), KERNEL_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S,P,N,chunk", SSD_SHAPES)
def test_ssd_scan_matches_jax(S, P, N, chunk, with_state):
    """ops.ssd_scan on the CPU (the kernel's plain version plus the host's
    recurrence) against the JAX package's ops.ssd_scan with the Pallas
    kernel in interpret mode and against its model's ssd_chunked."""
    arrays = _ssd_inputs(2, S, 2, P, N, seed=S)
    state = (np.random.default_rng(1).standard_normal((2, 2, P, N)).astype(
        np.float32) * 0.1 if with_state else None)
    jin, tin = _both(arrays)
    got_y, got_st = ops.ssd_scan(*tin, chunk=chunk, initial_state=None
                                 if state is None else torch.as_tensor(state))
    jstate = None if state is None else jnp.asarray(state)
    for want_y, want_st in (
            jax_ops.ssd_scan(*jin, chunk=chunk, interpret=True,
                             initial_state=jstate),
            jax_mamba.ssd_chunked(*jin, chunk=chunk, initial_state=jstate)):
        _close(got_y, want_y, KERNEL_TOL)
        _close(got_st, want_st, KERNEL_TOL)


def test_ssd_scan_prompt_shorter_than_a_chunk():
    """S < chunk: one chunk of S rows, as in the JAX package."""
    jin, tin = _both(_ssd_inputs(1, 24, 3, 16, 16, seed=5))
    got_y, got_st = ops.ssd_scan(*tin, chunk=32)
    want_y, want_st = jax_ops.ssd_scan(*jin, chunk=32, interpret=True)
    _close(got_y, want_y, KERNEL_TOL)
    _close(got_st, want_st, KERNEL_TOL)
    y, st = mamba.ssd_chunked(*tin, chunk=32)
    _close(got_y, to_numpy(y), KERNEL_TOL)
    _close(got_st, to_numpy(st), KERNEL_TOL)


def test_ssd_chunks_layout_matches_the_jax_grid():
    """ref.ssd_chunks writes the kernel's layouts: the same numbers as the
    JAX host side's (batch, head, chunk) grid, rearranged."""
    B, S, H, P, N, Q = 2, 64, 3, 16, 16, 16
    x, dt, A, Bm, Cm = _ssd_inputs(B, S, H, P, N, seed=9)
    a = (dt * A).astype(np.float32)
    xdt = (x * dt[..., None]).astype(np.float32)
    y, state, decay, cum = ref.ssd_chunks(
        torch.as_tensor(xdt), torch.as_tensor(a), torch.as_tensor(Bm[:, :, 0]),
        torch.as_tensor(Cm[:, :, 0]), Q)
    nc = S // Q
    xg = xdt.reshape(B, nc, Q, H, P).transpose(0, 3, 1, 2, 4).reshape(-1, Q, P)
    ag = a.reshape(B, nc, Q, H).transpose(0, 3, 1, 2).reshape(-1, Q)
    bc = [np.broadcast_to(m.reshape(B, nc, Q, 1, N), (B, nc, Q, H, N))
          .transpose(0, 3, 1, 2, 4).reshape(-1, Q, N) for m in (Bm, Cm)]
    wy, wst, wdec, wcum = map(np.asarray, jax_ssd.ssd_chunk_batch(
        *map(jnp.asarray, (xg, ag, *bc)), interpret=True))
    _close(y, wy.reshape(B, H, nc, Q, P).transpose(0, 2, 3, 1, 4).reshape(
        B, S, H, P), KERNEL_TOL)
    _close(state, wst.reshape(B, H, nc, P, N).transpose(0, 2, 1, 3, 4),
           KERNEL_TOL)
    _close(decay, wdec.reshape(B, H, nc).transpose(0, 2, 1), KERNEL_TOL)
    _close(cum, wcum.reshape(B, H, nc, Q).transpose(0, 2, 3, 1).reshape(
        B, S, H), KERNEL_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_jax(groups):
    """The model's own chunked scan, any number of groups."""
    jin, tin = _both(_ssd_inputs(2, 64, 4, 16, 8, G=groups, seed=groups))
    state = np.random.default_rng(2).standard_normal((2, 4, 16, 8)).astype(
        np.float32)
    got_y, got_st = mamba.ssd_chunked(*tin, chunk=16,
                                      initial_state=torch.as_tensor(state))
    want_y, want_st = jax_mamba.ssd_chunked(*jin, chunk=16,
                                            initial_state=jnp.asarray(state))
    _close(got_y, want_y, SCAN_TOL)
    _close(got_st, want_st, SCAN_TOL)


def test_ssd_scan_refusals():
    """No silent detour: grouped B/C, a chunk that does not divide S and a
    device with no kernel raise; so does mamba_apply with the kernel on and
    two groups (it never falls back to ssd_chunked)."""
    _, tin = _both(_ssd_inputs(1, 32, 2, 16, 16, G=2))
    with pytest.raises(NotImplementedError, match="n_groups = 2"):
        ops.ssd_scan(*tin, chunk=16)
    _, tin = _both(_ssd_inputs(1, 48, 2, 16, 16))
    with pytest.raises(ValueError, match="does not divide"):
        ops.ssd_scan(*tin, chunk=32)
    with pytest.raises(ValueError, match="does not divide"):
        mamba.ssd_chunked(*tin, chunk=32)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.ssd_scan(*(t.to("meta") for t in tin), chunk=16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ssd_kernel.ssd_chunk(torch.ones(1, 16, 2, 16), torch.ones(1, 16, 2),
                             torch.ones(1, 16, 16), torch.ones(1, 16, 16), 16)

    cfg = dataclasses.replace(get_arch(ARCH).reduced().ssm, n_groups=2)
    gen = torch.Generator().manual_seed(0)
    p = mamba.init_mamba(gen, 64, cfg)
    x = torch.randn((1, 32, 64), generator=gen)
    with pytest.raises(NotImplementedError, match="n_groups"):
        mamba.mamba_apply(p, x, cfg, 64)
    out, _, _ = mamba.mamba_apply(p, x, cfg, 64, use_kernel=False)
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def _block_setup(d_model=64, seed=0):
    cfg = get_arch(ARCH).reduced().ssm
    jp = jax_mamba.init_mamba(jax.random.PRNGKey(seed), d_model,
                              jax_get_arch(ARCH).reduced().ssm)
    return cfg, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                      "cpu")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mamba_apply_matches_jax(use_kernel):
    cfg, jp, p = _block_setup()
    x = np.random.default_rng(3).standard_normal((2, 64, 64)).astype(
        np.float32)
    want = jax_mamba.mamba_apply(jp, jnp.asarray(x),
                                 jax_get_arch(ARCH).reduced().ssm, 64)
    got = mamba.mamba_apply(p, torch.as_tensor(x), cfg, 64,
                            use_kernel=use_kernel)
    for g, w in zip(got, want):
        _close(g, w, SCAN_TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mamba_apply_bf16_matches_jax(use_kernel):
    """bf16 activations and weights (A_log, dt_bias, D f32): the port keeps
    JAX's dtypes through the scan, the f32 D and the out projection."""
    cfg = get_arch(ARCH).reduced().ssm
    jcfg = jax_get_arch(ARCH).reduced().ssm
    jp = jax_mamba.init_mamba(jax.random.PRNGKey(0), 64, jcfg,
                              dtype=jnp.bfloat16)
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    want = jax_mamba.mamba_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg, 64)
    got = mamba.mamba_apply(p, torch.as_tensor(x).bfloat16(), cfg, 64,
                            use_kernel=use_kernel)
    for g, w in zip(got, want):
        _close_bf16(g, w)
    x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
    ssm = (rng.standard_normal((2, 2, 64, 16)) * 0.1).astype(np.float32)
    conv = rng.standard_normal((2, 3, 128 + 32)).astype(np.float32)
    want = jax_mamba.mamba_decode_step(
        jp, jnp.asarray(x1, jnp.bfloat16), jnp.asarray(ssm),
        jnp.asarray(conv, jnp.bfloat16), jcfg, 64)
    got = mamba.mamba_decode_step(
        p, torch.as_tensor(x1).bfloat16(), torch.as_tensor(ssm),
        torch.as_tensor(conv).bfloat16(), cfg, 64)
    for g, w in zip(got, want):
        _close_bf16(g, w)


def test_mamba_decode_step_matches_jax():
    cfg, jp, p = _block_setup(seed=1)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    ssm = (rng.standard_normal((2, 2, 64, 16)) * 0.1).astype(np.float32)
    conv = rng.standard_normal((2, 3, 128 + 32)).astype(np.float32)
    want = jax_mamba.mamba_decode_step(
        jp, *map(jnp.asarray, (x, ssm, conv)),
        jax_get_arch(ARCH).reduced().ssm, 64)
    got = mamba.mamba_decode_step(p, *map(torch.as_tensor, (x, ssm, conv)),
                                  cfg, 64)
    for g, w in zip(got, want):
        _close(g, w, SCAN_TOL)


# ---------------------------------------------------------------------------
# reduced mamba2-1.3b: forward, caches, decode, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dropped", [False, True])
def test_forward_matches_jax(setup, dropped):
    """Monolithic forward (towers, merge with a live mask, server, head)
    through the kernel's plain version and through ssd_chunked."""
    jcfg, cfg, jparams, params = setup
    toks = _tokens(cfg, (2, 64))
    live = np.array([1.0, 0.0], np.float32) if dropped else None
    want, _ = jax_backbone.forward(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg,
        live_mask=None if live is None else jnp.asarray(live))
    for use_kernel in (True, False):
        got, aux = backbone.forward(
            params, {"tokens": torch.as_tensor(toks)}, cfg,
            live_mask=None if live is None else torch.as_tensor(live),
            use_kernel=use_kernel)
        _close(got, want, LOGIT_TOL)
        assert float(aux) == 0.0
    if live is None:  # make_prefill serves every client
        prefill = backbone.make_prefill(cfg)
        _close(prefill(params, {"tokens": torch.as_tensor(toks)}), want,
               LOGIT_TOL)


def test_forward_bf16_matches_jax():
    """Reduced mamba2-1.3b with a bf16 tree, through the kernel's plain
    version and through ssd_chunked."""
    jcfg = jax_get_arch(ARCH).reduced()
    cfg = get_arch(ARCH).reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0,
                      static_argnames="dtype")(jcfg, jax.random.PRNGKey(0),
                                               dtype=jnp.bfloat16)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    toks = _tokens(cfg, (2, 64))
    want, _ = jax.jit(lambda p, t: jax_backbone.forward(
        p, {"tokens": t}, jcfg))(jparams, jnp.asarray(toks))
    for use_kernel in (True, False):
        got, _ = backbone.forward(params, {"tokens": torch.as_tensor(toks)},
                                  cfg, use_kernel=use_kernel)
        assert float(np.abs(np.asarray(want.astype(jnp.float32))).max()) < 4
        _close_bf16(got, want, BF16_LOGIT_TOL)


@pytest.mark.parametrize("dropped", [False, True])
def test_dense_forward_matches_jax(dropped):
    """The dense family's monolithic forward: its towers, the merge with a
    live mask, the server trunk and the head."""
    jcfg = jax_get_arch("smollm-360m").reduced()
    cfg = get_arch("smollm-360m").reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    toks = _tokens(cfg, (2, 24), seed=3)
    live = np.array([0.0, 1.0] if dropped else [1.0, 1.0], np.float32)
    want, _ = jax.jit(lambda p, b, lv: jax_backbone.forward(
        p, b, jcfg, live_mask=lv))(jparams, {"tokens": jnp.asarray(toks)},
                                   jnp.asarray(live))
    got, _ = backbone.forward(params, {"tokens": torch.as_tensor(toks)}, cfg,
                              live_mask=torch.as_tensor(live))
    _close(got, want, LOGIT_TOL)


def _shapes(tree):
    """(shape, dtype name) per leaf, of a JAX or a torch tree."""
    return jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).removeprefix("torch.")),
        tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_tree_matches_jax(dtype):
    """The port's seeded init draws the JAX package's tree: same keys,
    shapes and dtypes (A_log, dt_bias and D f32 in a bf16 tree), and that
    tree carries across by interop with its dtypes; the init ranges of A
    and dt are the JAX package's."""
    jcfg, cfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jparams = jax.jit(jax_backbone.init_params, static_argnums=(0, 2))(
        jcfg, jax.random.PRNGKey(0), getattr(jnp, dtype))
    params = backbone.init_params(cfg, device="cpu",
                                  dtype=getattr(torch, dtype))
    assert _shapes(params) == _shapes(jparams)
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                "cpu")
    assert _shapes(carried) == _shapes(jparams)
    m = params["server"]["mamba"]
    assert {m[k].dtype for k in ("A_log", "dt_bias", "D")} == {torch.float32}
    A = torch.exp(m["A_log"])
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert 1.0 <= float(A.min()) <= float(A.max()) <= 16.0
    assert 0.999e-3 <= float(dt.min()) <= float(dt.max()) <= 0.1001


def test_init_cache_matches_jax():
    jcfg, cfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    cache = backbone.init_cache(cfg, 3, 20, device="cpu")
    assert _shapes(cache) == _shapes(jax_backbone.init_cache(jcfg, 3, 20))
    assert int(cache["index"]) == 0
    assert (cache["kv_positions"] == -1).all()


def test_decode_step_matches_jax(setup):
    """Three steps into a prompt, both packages' caches and the fourth
    step's logits agree."""
    jcfg, cfg, jparams, params = setup
    toks = _tokens(cfg, (2, 4), seed=6)
    step = jax.jit(lambda p, c, t: jax_backbone.decode_step(p, c, t, jcfg))
    jcache = jax_backbone.init_cache(jcfg, 2, 16)
    cache = backbone.init_cache(cfg, 2, 16, device="cpu")
    for t in range(3):
        _, jcache = step(jparams, jcache, jnp.asarray(toks[:, t]))
        _, cache = backbone.decode_step(params, cache,
                                        torch.as_tensor(toks[:, t]), cfg)
    want, jnew = step(jparams, jcache, jnp.asarray(toks[:, 3]))
    got, new = backbone.decode_step(params, cache,
                                    torch.as_tensor(toks[:, 3]), cfg)
    _close(got, want, LOGIT_TOL)
    assert int(new["index"]) == int(jnew["index"]) == 4
    for key in ("ssm", "conv"):
        _close(new[key], jnew[key], LOGIT_TOL)
        _close(new["tower"][key], jnew["tower"][key], LOGIT_TOL)


def test_decode_matches_forward(setup):
    """The port's twin of the JAX package's test_decode_matches_forward:
    step-by-step cached decode reproduces the teacher-forced forward."""
    _, cfg, _, params = setup
    toks = torch.as_tensor(_tokens(cfg, (2, 8), seed=7))
    full, _ = backbone.forward(params, {"tokens": toks}, cfg)
    cache = backbone.init_cache(cfg, 2, 8, device="cpu")
    outs = []
    for t in range(8):
        lg, cache = backbone.decode_step(params, cache, toks[:, t], cfg)
        outs.append(lg)
    np.testing.assert_allclose(to_numpy(torch.stack(outs, dim=1)),
                               to_numpy(full), rtol=2e-3, atol=2e-3)


def test_generate_greedy_matches_jax(setup):
    jcfg, cfg, jparams, params = setup
    prompts = _tokens(cfg, (3, 10), seed=8)
    want = jax_decode.generate(jparams, jcfg, jnp.asarray(prompts),
                               max_new_tokens=7)
    got = generate(params, cfg, prompts, max_new_tokens=7)
    assert got.shape == (3, 7) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="cache_len"):
        generate(params, cfg, prompts, max_new_tokens=7, cache_len=12)


def test_unported_paths_raise_by_name(setup):
    """The ssm family has no fused prompt prefill (its generate replays
    the prompt, as the JAX package's does); the other families are later
    slices.  A compressed config runs (the straight-through codec before
    the merge, as in the JAX package's forward).  (Split execution of the ssm family is
    ported: ``tests/test_torch_ssd_train.py``; dense monolithic serving:
    ``tests/test_torch_dense_decode.py``.)"""
    jcfg, cfg, jparams, params = setup
    with pytest.raises(NotImplementedError, match="prompt prefill"):
        backbone.prefill_tokens(params,
                                backbone.init_cache(cfg, 1, 4, device="cpu"),
                                torch.zeros((1, 2), dtype=int), cfg)
    with pytest.raises(NotImplementedError, match="'hybrid' family"):
        generate({"x": torch.zeros(1)}, dataclasses.replace(
            cfg, family="hybrid"), np.zeros((1, 2)))
    compressed = cfg.with_vertical(dataclasses.replace(
        cfg.vertical, compression="int8"))
    jcompressed = jcfg.with_vertical(dataclasses.replace(
        jcfg.vertical, compression="int8"))
    tokens = _tokens(cfg, (1, 8), seed=3)
    want, _ = jax_backbone.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                   jcompressed)
    got, _ = backbone.forward(params, {"tokens": torch.from_numpy(tokens)},
                              compressed)
    _close(got, want, LOGIT_TOL)
    hybrid = dataclasses.replace(cfg, family="hybrid")
    with pytest.raises(NotImplementedError, match="'hybrid' family"):
        backbone.init_params(hybrid, device="cpu")
    with pytest.raises(NotImplementedError, match="'moe' family"):
        backbone.init_params(dataclasses.replace(cfg, family="moe"),
                             device="cpu")
    # the centralized baseline is ported (tests/test_torch_train_mono.py)
    central = backbone.init_params(cfg.with_vertical(None), device="cpu")
    assert "towers" not in central
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(central)) == \
        backbone.param_count(cfg.with_vertical(None))


# ---------------------------------------------------------------------------
# the CUDA chunk kernel's arithmetic and operand layout, modelled in numpy
# ---------------------------------------------------------------------------

KERNEL_ROWS = 128  # chunk rows a block's tiles hold (two warpgroups of 64)
B_SLICE = 64       # d_state columns of C B^T per staged B slice
SBO_ROWS = (KERNEL_ROWS // 4) * 128  # tiles with the chunk's rows along K
SBO_SLICE = (B_SLICE // 4) * 128     # a B slice (d_state along K)
# (Q, P, N): every chunk length, head dim and d_state class the kernel
# takes on the model's paths (Q 96: a prompt shorter than a chunk)
MODEL_CASES = [(q, p, n) for q in (32, 96, 128) for p in (16, 32, 64)
               for n in (16, 128)]


def _renamed(k):
    """The chunk row j stored at K position k of a tile with the chunk's
    rows along K (x^T, B^T): within each 8-step, positions t and t + 4
    hold rows 2t and 2t + 1, the columns that C B^T's accumulator gives
    lane t (S is used as wgmma's A operand without moving)."""
    k = np.asarray(k)
    return 8 * (k // 8) + 2 * (k % 4) + (k % 8) // 4


def _state_columns(n):
    """State columns per block (``Plan::nt``): a power of two 16..128."""
    return 128 if n > 64 else 64 if n > 32 else 32 if n > 16 else 16


def _kernel_scan(a):
    """cum as warp 0 takes it: lane l sums a[4l .. 4l + 3] in order, the
    lanes' totals are scanned with shuffles up by 1, 2, 4, 8 and 16, and
    each lane adds the total before it.  a past Q is zero.  Returns cum
    (Q,) and cum_Q, in f32."""
    Q = len(a)
    v = np.zeros(KERNEL_ROWS, np.float32)
    v[:Q] = a
    v = np.cumsum(v.reshape(32, 4), axis=1, dtype=np.float32)
    run = v[:, 3].copy()
    lane = np.arange(32)
    for d in (1, 2, 4, 8, 16):
        run = np.where(lane >= d, run + np.roll(run, d), run).astype(
            np.float32)
    cum = (v + (run - v[:, 3])[:, None]).reshape(-1)
    return cum[:Q], run[31]


def _kernel_chunk(x, a, Bm, Cm, passes=3):
    """One chunk of one head as the kernel computes it: C B^T, S = C B^T
    masked above the diagonal before exp(cum_i - cum_j), y = S x, and
    state = (x o w)^T B with w_j = exp(cum_Q - cum_j) and x rebuilt from
    its TF32 split (hi + lo), every product through _tf32_product
    (``passes=1``: a single TF32 pass)."""
    Q = len(a)
    cum, last = _kernel_scan(a)
    G = _tf32_product(Cm, Bm.T, passes)
    lower = np.tril(np.ones((Q, Q), bool))
    L = np.exp(np.where(lower, cum[:, None] - cum[None, :], -np.inf)).astype(
        np.float32)
    y = _tf32_product(G * L, x, passes)
    w = np.exp(last - cum).astype(np.float32)
    hi, lo = _split(x)
    state = _tf32_product(((hi + lo) * w[:, None]).T, Bm, passes)
    return y, state, np.exp(last), cum


@pytest.mark.parametrize("Q,P,N", MODEL_CASES)
def test_3xtf32_ssd_kernel_model_matches_pallas(Q, P, N):
    """The kernel's arithmetic on two heads of one chunk (shared B and C)
    against the JAX package's Pallas kernel in interpret mode at its
    3e-4; a single TF32 pass errs at least 10x more on y and the state."""
    rng = np.random.default_rng(Q * P + N)
    H = 2
    x = (rng.standard_normal((H, Q, P)) * 0.7).astype(np.float32)
    a = (-np.exp(rng.standard_normal((H, 1)) * 0.3)
         * np.log1p(np.exp(rng.standard_normal((H, Q)) * 0.5))).astype(
             np.float32)
    Bm = (rng.standard_normal((Q, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((Q, N)) * 0.3).astype(np.float32)
    want = [np.asarray(w) for w in jax_ssd.ssd_chunk_batch(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(np.stack([Bm] * H)),
        jnp.asarray(np.stack([Cm] * H)), interpret=True)]
    err = {1: 0.0, 3: 0.0}
    for h in range(H):
        for passes in (3, 1):
            got = _kernel_chunk(x[h], a[h], Bm, Cm, passes)
            if passes == 3:
                for g, w in zip(got, (wt[h] for wt in want)):
                    np.testing.assert_allclose(g, w.reshape(np.shape(g)),
                                               **KERNEL_TOL)
            err[passes] = max(err[passes], *(
                float(np.abs(g - w[h]).max())
                for g, w in zip(got[:2], want[:2])))
    assert err[1] >= 10 * err[3], err


def _c_bt_by_warpgroup(Bp, Cp, Q, N):
    """C B^T as the kernel builds it: per B slice of 64 d_state columns,
    the split pass's thread idx writes core matrix idx // 8, row idx % 8
    (row j, columns 4 kb .. 4 kb + 3) at word 4 idx; warpgroup w's C
    fragments are rows 64w .. 64w + 63 of the slice's 8-column k-steps
    (rows past Q and columns past N zero), and its wgmma reads 64 (w = 0)
    or 128 (w = 1) rows of the tile through a descriptor (start
    kk * 2 * CORE, SBO 16 core matrices).  Returns {w: accumulator}."""
    acc = {w: np.zeros((4, 32, 32 * (w + 1))) for w in (0, 1)}
    for n0 in range(0, N, B_SLICE):
        ns = min(B_SLICE, N - n0)
        tile = np.zeros(KERNEL_ROWS * B_SLICE)
        for idx in range(KERNEL_ROWS * B_SLICE // 4):
            kb = (idx >> 3) % (B_SLICE // 4)
            j = 8 * ((idx >> 3) // (B_SLICE // 4)) + (idx & 7)
            if 4 * kb < ns:
                tile[4 * idx:4 * idx + 4] = Bp[j, n0 + 4 * kb:n0 + 4 * kb + 4]
            assert 4 * idx == _core_index(j, 4 * kb, B_SLICE)
        for w, d in acc.items():
            for kk in range(B_SLICE // 8):
                cols = np.zeros((64, 8))
                if 8 * kk < ns:
                    cols = Cp[64 * w:64 * w + 64, n0 + 8 * kk:n0 + 8 * kk + 8]
                acc[w] = _wgmma(_fragments(cols), _wgmma_b(
                    tile, kk * 2 * CORE, SBO_SLICE, 64 * (w + 1)), d)
                d = acc[w]
    return acc


def _rows_tile(M, rows):
    """A tile with the chunk's rows along K, from M (KERNEL_ROWS, rows):
    thread idx takes row r = idx % rows and positions 4 kb .. 4 kb + 3
    (chunk rows 8 (kb // 2) + kb % 2 + 2e) and stores them at
    core_index(r, 4 kb, KERNEL_ROWS): the x^T and B^T split passes."""
    tile = np.zeros(rows * KERNEL_ROWS)
    for idx in range(rows * KERNEL_ROWS // 4):
        r, kb = idx % rows, idx // rows
        at = _core_index(r, 4 * kb, KERNEL_ROWS)
        tile[at:at + 4] = M[8 * (kb >> 1) + (kb & 1) + 2 * np.arange(4), r]
    return tile


@pytest.mark.parametrize("Q,P,N", MODEL_CASES)
def test_ssd_kernel_operand_layout_and_fragments(Q, P, N):
    """The kernel's indexing, exact in float64, on one chunk of one head
    with its rows past Q zero-filled: the B slices and C fragments give
    C B^T by warpgroup; S built per accumulator element (lane 4g + t of
    warp w, element 4 kk + i: row 64 wg + 16 w + g + 8 (i // 2), chunk
    row 8 kk + 2t + i % 2), masked and decay-weighted, and used as A with
    its columns renamed (elements 0, 2, 1, 3) against x^T (positions
    renamed, descriptor at kk * 2 * CORE, SBO 32 core matrices) gives
    y = ((C B^T) o L) x; A fragments of (x o w)^T read from x^T at
    core_index(p0, 8 kk + t) (+ 32 core matrices for row p0 + 8, + CORE
    for position t + 4) against each warpgroup's half of B^T give the
    state."""
    rng = np.random.default_rng(Q + P + N)
    x, Bm, Cm = (rng.standard_normal(s) for s in ((Q, P), (Q, N), (Q, N)))
    cum = np.cumsum(-np.abs(rng.standard_normal(Q)) * 0.1)
    pad = KERNEL_ROWS - Q
    xp, Bp, Cp = (np.pad(m, ((0, pad), (0, 0))) for m in (x, Bm, Cm))
    cump = np.pad(cum, (0, pad), constant_values=cum[-1])
    w_j = np.pad(np.exp(cum[-1] - cum), (0, pad))
    g, t = _lanes()
    full = Cm @ Bm.T * np.where(np.tril(np.ones((Q, Q), bool)),
                                np.exp(cum[:, None] - cum[None, :]), 0)

    acc = _c_bt_by_warpgroup(Bp, Cp, Q, N)
    xt = _rows_tile(xp, P)
    for k in range(KERNEL_ROWS):
        np.testing.assert_array_equal(
            xt[[_core_index(p, k, KERNEL_ROWS) for p in range(P)]],
            xp[_renamed(k)])
    for w, d in acc.items():
        rows = slice(64 * w, 64 * w + 64)
        cols = 64 * (w + 1)
        np.testing.assert_allclose(_from_wgmma(d), Cp[rows] @ Bp[:cols].T,
                                   rtol=1e-12, atol=1e-12)
        # the decay mask by accumulator element, then y in the kernel's
        # fixed batches of four k-steps: two for warpgroup 0, four for 1
        i = np.arange(d.shape[2])
        row = 64 * w + 16 * np.arange(4)[:, None, None] + g[None, :, None] \
            + 8 * ((i >> 1) & 1)
        j = 8 * (i >> 2) + 2 * t[None, :, None] + (i & 1)
        s = d * np.where(j <= row, np.exp(cump[row] - cump[j]), 0.0)
        yacc = np.zeros((4, 32, P // 2))
        for kk in range(8 * (w + 1)):
            a = s[:, :, [4 * kk, 4 * kk + 2, 4 * kk + 1, 4 * kk + 3]]
            yacc = _wgmma(a, _wgmma_b(xt, kk * 2 * CORE, SBO_ROWS, P), yacc)
        valid = max(0, min(Q, 64 * (w + 1)) - 64 * w)
        np.testing.assert_allclose(_from_wgmma(yacc)[:valid],
                                   (full @ x)[64 * w:64 * w + valid],
                                   rtol=1e-12, atol=1e-12)

    nt = _state_columns(N)  # >= N here: one block covers the state
    half = nt // 2
    bt = _rows_tile(np.pad(Bp, ((0, 0), (0, nt - N))), nt)
    want = (x * w_j[:Q, None]).T @ np.pad(Bm, ((0, 0), (0, nt - N)))
    p0 = 16 * np.arange(4)[:, None] + g[None, :]
    for w in (0, 1):
        sacc = np.zeros((4, 32, half // 2))
        for kk in range(KERNEL_ROWS // 8):  # four batches, whatever Q
            at = np.vectorize(_core_index)(p0, 8 * kk + t[None, :],
                                           KERNEL_ROWS)
            at8 = at + (KERNEL_ROWS // 4) * CORE

            def value(i, ok):
                return np.where(ok, xt[np.where(ok, i, 0)], 0.0)

            wj = w_j[8 * kk + 2 * t[None, :]], w_j[8 * kk + 2 * t[None, :] + 1]
            frag = np.stack([value(at, p0 < P) * wj[0],
                             value(at8, p0 + 8 < P) * wj[0],
                             value(at + CORE, p0 < P) * wj[1],
                             value(at8 + CORE, p0 + 8 < P) * wj[1]], axis=-1)
            sacc = _wgmma(frag, _wgmma_b(
                bt, w * half * KERNEL_ROWS + kk * 2 * CORE, SBO_ROWS, half),
                sacc)
        np.testing.assert_allclose(_from_wgmma(sacc)[:P],
                                   want[:, w * half:(w + 1) * half],
                                   rtol=1e-12, atol=1e-12)
