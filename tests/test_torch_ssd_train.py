"""The port's ssm split training against the JAX package: the SSD chunk
terms' written-out backward (``ref.ssd_chunks_bwd``, the plain twin of the
CUDA ``ssd_chunk_bwd_kernel``), the gradients of ``ops.ssd_scan`` through
``ops.SSDChunk``, one Mamba2 block's gradients, the ssm branch of the
token-LM split program and ``protocol_step``, and ``train_split`` on
reduced mamba2-1.3b (2 layers, d_model 256, K = 2 towers of 1 layer,
d_state 16, chunks of 32, vocab 512) with the JAX package's params carried
across by ``interop``.  ``tests/test_torch_ssd_train_serial.py`` and
``tests/test_torch_ssd_train_pipelined.py`` run :func:`run_against_jax`
serially and at M = 4 (a file each, so that each runs in about a minute:
the JAX package compiles op by op).

Inputs are made from a seed with numpy and fed to both packages; f32
throughout.  The Pallas SSD kernel has no backward: the JAX package
differentiates its plain chunked path, so the chunk terms are held to
``jax.vjp`` of its ``ref.ssd_chunk`` (vmapped) and the scan to
``jax.grad`` of its ``ops.ssd_scan(use_pallas=False)`` and of its model's
``ssd_chunked``.  Tolerances: 1e-5 where the two packages run the same
algorithm and differ only in summation order (the chunk terms, the scan,
the block, one protocol step); 1e-4 for losses and params after three
AdamW steps (slice 2's, ``tests/test_torch_train_split.py``), with the
port's own step-0 verification at 1e-5.  The JAX package's init, towers
and server run compiled (``tests/jax_compiled.py``), here and in the two
files that import this one's fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.data.loader import LMBatchLoader as JaxLMBatchLoader
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import backbone as jax_backbone
from repro.models import mamba as jax_mamba
from repro.models import split_program as jax_split_program
from repro.models import transformer as jax_tfm
from repro.train.loop import train_split as jax_train_split
from repro_torch.configs.base import get_arch
from repro_torch.data.loader import LMBatchLoader
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import split_program
from repro_torch.models import transformer as tfm
from repro_torch.train.loop import train_split
from repro_torch.transport import build_split_worker
from jax_compiled import compiled_reference

ARCH = "mamba2-1.3b"
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
# A's gradient sums dt * da over every position of every sequence, each da
# carrying f32 round-off of ~2e-6: both packages' sums carry up to ~5e-5
# of it (against a float64 evaluation at these inputs: the JAX package's
# ops.ssd_scan 5.2e-5, its ssd_chunked 2.2e-5, the port 4.6e-5)
A_GRAD_TOL = dict(rtol=1e-5, atol=1e-4)
RUN_TOL = dict(rtol=1e-4, atol=1e-4)
# 64 tokens: two chunks of the reduced config's 32, so the cross-chunk
# carry and its gradient run
BATCH, SEQ, STEPS = 4, 64, 3
# (Q, P, N, nc, H): the reduced config's chunk and d_state, the JAX
# package's own kernel-test shapes, one chunk and three
BWD_CASES = [(32, 16, 16, 2, 3), (16, 32, 32, 3, 2), (64, 16, 16, 1, 2)]
UPSTREAMS = {"all": (True, True, True), "gy": (True, False, False),
             "gstate": (False, True, False), "gcum": (False, False, True)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def _compiled_reference():
    """The JAX package's init, towers and server compiled
    (``tests/jax_compiled.py``)."""
    with compiled_reference():
        yield


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_arch(ARCH).reduced()
    # eager, as the JAX train_split and its workers run the init
    jparams = jax_backbone.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu")
    cfg = get_arch(ARCH).reduced()
    jprog = jax_split_program.get_program(jcfg)
    prog = split_program.get_program(cfg)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jprog=jprog, prog=prog, jparts=jprog.partition(jparams),
                parts=prog.partition(params),
                batch=LMBatchLoader(cfg, BATCH, SEQ, seed=0).next_batch())


def _close(got, want, tol=GRAD_TOL):
    """``got`` a tree of tensors, ``want`` the same tree of arrays."""
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


def _close_to_scale(got, want, tol=1e-5):
    """Each leaf within ``tol`` of its largest entry (and ``tol``
    relative): a weight gradient sums over every token, and its f32
    round-off scales with its largest entries, not its smallest."""
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * float(np.abs(b).max()))


def _chunk_inputs(B, Q, P, N, nc, H, seed):
    """xdt, a, B, C in the kernel's layouts and the three upstream
    gradients, drawn with numpy: the JAX kernel test's distributions."""
    rng = np.random.default_rng(seed)
    S = Q * nc
    arrays = (rng.standard_normal((B, S, H, P)),
              -np.abs(rng.standard_normal((B, S, H)) * 0.3),
              rng.standard_normal((B, S, N)) * 0.3,
              rng.standard_normal((B, S, N)) * 0.3,
              rng.standard_normal((B, S, H, P)),
              rng.standard_normal((B, nc, H, P, N)),
              rng.standard_normal((B, S, H)))
    return [a.astype(np.float32) for a in arrays]


def _to_grid(t, B, nc, Q, H):
    """(B, S, H, ...) -> the JAX host side's (B * H * nc, Q, ...) grid."""
    rest = t.shape[3:]
    t = t.reshape((B, nc, Q, H) + rest)
    return np.moveaxis(t, 3, 1).reshape((-1, Q) + rest)


def _from_grid(t, B, nc, Q, H):
    rest = t.shape[2:]
    t = np.moveaxis(np.asarray(t).reshape((B, H, nc, Q) + rest), 1, 3)
    return t.reshape((B, nc * Q, H) + rest)


def _jax_chunks_vjp(xdt, a, Bm, Cm, gy, gstate, gcum, Q):
    """jax.vjp of the JAX package's ref.ssd_chunk, vmapped over its
    (batch, head, chunk) grid with B and C broadcast over the heads, back
    in the port's layouts (dB and dC summed over the heads)."""
    B, S, H, P = xdt.shape
    N, nc = Bm.shape[-1], S // Q
    heads = lambda m: np.broadcast_to(m[:, :, None], (B, S, H, N))  # noqa
    ins = [_to_grid(xdt, B, nc, Q, H), _to_grid(a[..., None], B, nc, Q, H),
           _to_grid(heads(Bm), B, nc, Q, H), _to_grid(heads(Cm), B, nc, Q, H)]
    ins[1] = ins[1][..., 0]
    _, vjp = jax.vjp(jax.vmap(jax_ref.ssd_chunk), *map(jnp.asarray, ins))
    G = B * H * nc
    cot = (_to_grid(gy, B, nc, Q, H),
           np.moveaxis(gstate, 2, 1).reshape(G, P, N),
           np.zeros((G,), np.float32),
           _to_grid(gcum[..., None], B, nc, Q, H)[..., 0])
    dx, da, dB, dC = vjp(tuple(map(jnp.asarray, cot)))
    dB, dC = (_from_grid(d, B, nc, Q, H).sum(2) for d in (dB, dC))
    return (_from_grid(dx, B, nc, Q, H),
            _from_grid(np.asarray(da)[..., None], B, nc, Q, H)[..., 0],
            dB, dC)


@pytest.mark.parametrize("upstream", list(UPSTREAMS))
@pytest.mark.parametrize("Q,P,N,nc,H", BWD_CASES)
def test_ssd_chunks_bwd_matches_jax_vjp_and_autograd(Q, P, N, nc, H,
                                                     upstream):
    """ref.ssd_chunks_bwd, written out in the kernel's layouts, against
    jax.vjp of the JAX package's ref.ssd_chunk and against torch autograd
    of the port's ref.ssd_chunks; an absent upstream gradient (None here)
    is a zero cotangent there."""
    xdt, a, Bm, Cm, *ups = _chunk_inputs(2, Q, P, N, nc, H, seed=Q * nc + H)
    present = UPSTREAMS[upstream]
    ups = [u if on else np.zeros_like(u) for u, on in zip(ups, present)]
    got = ref.ssd_chunks_bwd(
        *map(torch.as_tensor, (xdt, a, Bm, Cm)),
        *(torch.as_tensor(u) if on else None for u, on in zip(ups, present)),
        Q)
    want = _jax_chunks_vjp(xdt, a, Bm, Cm, *ups, Q)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.is_contiguous()
        _close(g, w)
    leaves = [torch.tensor(v, requires_grad=True) for v in (xdt, a, Bm, Cm)]
    y, state, _, cum = ref.ssd_chunks(*leaves, Q)
    auto = torch.autograd.grad(
        (y * torch.as_tensor(ups[0])).sum()
        + (state * torch.as_tensor(ups[1])).sum()
        + (cum * torch.as_tensor(ups[2])).sum(), leaves)
    for g, w in zip(got, auto):
        _close(g, w.numpy())


def test_ssd_chunks_bwd_finite_at_very_negative_a():
    """a = -80 per step: above the diagonal cum_i - cum_j reaches 10^4,
    whose exponential overflows.  The plain backward masks before the
    exponential and stays finite, equal to autograd of the plain forward
    (which masks likewise); exp(-80) underflows below the diagonal."""
    xdt, a, Bm, Cm, gy, gstate, gcum = _chunk_inputs(1, 128, 16, 16, 2, 2,
                                                     seed=11)
    a = np.full_like(a, -80.0)
    tin = [torch.tensor(v, requires_grad=True) for v in (xdt, a, Bm, Cm)]
    got = ref.ssd_chunks_bwd(*[t.detach() for t in tin],
                             *map(torch.as_tensor, (gy, gstate, gcum)), 128)
    y, state, _, cum = ref.ssd_chunks(*tin, 128)
    auto = torch.autograd.grad(
        (y * torch.as_tensor(gy)).sum() + (state * torch.as_tensor(
            gstate)).sum() + (cum * torch.as_tensor(gcum)).sum(), tin)
    for g, w in zip(got, auto):
        assert torch.isfinite(g).all()
        _close(g, w.numpy())


def _scan_inputs(S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((2, S, H, P)),
              np.log1p(np.exp(rng.standard_normal((2, S, H)) * 0.5)),
              -np.exp(rng.standard_normal((H,)) * 0.3),
              rng.standard_normal((2, S, 1, N)) * 0.3,
              rng.standard_normal((2, S, 1, N)) * 0.3,
              rng.standard_normal((2, H, P, N)) * 0.1,
              rng.standard_normal((2, S, H, P)),
              rng.standard_normal((2, H, P, N)))
    return [v.astype(np.float32) for v in arrays]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S,chunk", [(32, 32), (96, 32)])
def test_ssd_scan_grads_match_jax(S, chunk, with_state):
    """The gradients of ops.ssd_scan (the chunk terms through SSDChunk,
    the recurrence and y_off through autograd) wrt x, dt, A, B, C and the
    initial state, at one chunk and at three, against jax.grad of the JAX
    package's ops.ssd_scan(use_pallas=False) and of its ssd_chunked."""
    H, P, N = 3, 16, 16
    *inputs, state, gy, gfin = _scan_inputs(S, H, P, N, seed=S + with_state)
    if not with_state:
        state = None
    n_in = 5 + with_state
    leaves = inputs + ([state] if with_state else [])

    def jax_loss(fn):
        def loss(*args):
            y, fin = fn(*args[:5], chunk, initial_state=args[5]
                        if with_state else None)
            return jnp.sum(y * gy) + jnp.sum(fin * gfin)
        return loss

    tin = [torch.tensor(v, requires_grad=True) for v in leaves]
    y, fin = ops.ssd_scan(*tin[:5], chunk,
                          initial_state=tin[5] if with_state else None)
    got = torch.autograd.grad(
        (y * torch.as_tensor(gy)).sum() + (fin * torch.as_tensor(gfin)).sum(),
        tin)
    scan = lambda *a, **kw: jax_ops.ssd_scan(*a, use_pallas=False,  # noqa
                                             **kw)
    for fn in (scan, jax_mamba.ssd_chunked):
        want = jax.jit(jax.grad(jax_loss(fn), argnums=tuple(range(n_in))))(
            *map(jnp.asarray, leaves))
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, A_GRAD_TOL if i == 2 else GRAD_TOL)


def test_mamba_block_grads_match_jax(setup):
    """One Mamba2 block of the server (its ops.ssd_scan through SSDChunk):
    the gradient of its input at 1e-5 and of every param within 1e-5 of
    the param's largest entry against jax.grad of the JAX package's block;
    the model's plain path (``use_kernel=False``: autograd of its own
    ssd_chunked, no SSDChunk) differs from the JAX package's weight
    gradients by as much (4.0e-5 on out_proj's, whose largest entry is
    58), and agrees with the SSDChunk path at the same scale."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jp = jax.tree_util.tree_map(lambda t: t[0], setup["jparams"]["server"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, SEQ, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out, _, _ = jax_tfm.mamba_block_apply(p, x, jcfg.ssm, jcfg.d_model,
                                              jcfg.norm_eps)
        return jnp.sum(out * g)

    want_p, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    runs = []
    for use_kernel in (True, False):
        p = jax.tree_util.tree_map(
            lambda t: torch.tensor(np.asarray(t), requires_grad=True), jp)
        tx = torch.tensor(x, requires_grad=True)
        out, _, _ = tfm.mamba_block_apply(p, tx, cfg.ssm, cfg.d_model,
                                          cfg.norm_eps, use_kernel=use_kernel)
        leaves = jax.tree_util.tree_leaves(p)
        grads = torch.autograd.grad((out * torch.as_tensor(g)).sum(),
                                    leaves + [tx])
        runs.append(grads)
    grads, plain = runs
    _close(grads[-1], want_x)
    _close_to_scale(grads[:-1], jax.tree_util.tree_leaves(want_p))
    _close_to_scale(grads, [t.numpy() for t in plain])


def test_ssm_program_and_partition_match_jax(setup):
    """get_program registers the token-LM program for the ssm family; its
    partition, tower_fwd (Mamba2 towers of width d_model / K) and
    server_fwd (the Mamba2 trunk) against the JAX package's."""
    jprog, prog, batch = setup["jprog"], setup["prog"], setup["batch"]
    assert type(prog) is split_program.TokenLMSplitProgram
    (jtowers, jserver), (towers, server) = setup["jparts"], setup["parts"]
    _close((towers, server), (jtowers, jserver), dict(rtol=0, atol=0))
    jtok, tok = jnp.asarray(batch["tokens"]), torch.from_numpy(
        batch["tokens"])
    jcuts, cuts = [], []
    for k in range(prog.num_clients):
        jcuts.append(jprog.tower_fwd(k)(jtowers[k], jtok))
        cuts.append(prog.tower_fwd(k)(towers[k], tok))
        assert tuple(cuts[k].shape) == (BATCH, SEQ, setup["cfg"].d_model)
        _close(cuts[k], jcuts[k])
    _close(prog.server_fwd(server, torch.stack(cuts).mean(0)),
           jprog.server_fwd(jserver, jnp.stack(jcuts).mean(0)))


def test_ssm_protocol_step_matches_jax(setup):
    """One serial protocol step: loss, tower and server grads at 1e-5 (the
    server's untied input table, which its forward does not read, gets a
    zero gradient in both packages)."""
    jprog, prog, batch = setup["jprog"], setup["prog"], setup["batch"]
    (jtowers, jserver), (towers, server) = setup["jparts"], setup["parts"]
    jloss, jtg, jsg, _ = jprog.protocol_step(
        jtowers, jserver, jprog.features(batch), jprog.batch_ctx(batch))
    loss, tg, sg, _ = prog.protocol_step(
        towers, server, prog.features(batch, "cpu"),
        prog.batch_ctx(batch, "cpu"))
    _close(loss, jloss)
    _close(tg, jtg)
    _close(sg, jsg)
    assert not sg["embed"]["table"].any()


def test_ssm_worker_trains_and_refuses_serving(setup):
    """build_split_worker builds an ssm feature holder (the shared token
    stream) whose serving ops refuse by name, as the JAX package's; the
    program's serving bundles refuse the ssm family."""
    cfg = setup["cfg"]
    worker = build_split_worker(0, cfg=cfg, batch=BATCH, seq=SEQ,
                                params=setup["params"], device="cpu")
    feats = worker.feature_fn(0, 0)
    assert tuple(feats.shape) == (BATCH, SEQ) and feats.dtype == torch.long
    np.testing.assert_array_equal(feats.numpy(), setup["batch"]["tokens"])
    with pytest.raises(ValueError, match="no serve_fns"):
        worker._require_serving()
    for make in (lambda: setup["prog"].tower_serve_fns(0),
                 setup["prog"].server_serve_fns):
        with pytest.raises(NotImplementedError, match="dense token-LM"):
            make()


def run_against_jax(setup, runtime: str, microbatches: int = 1) -> None:
    """Three steps of the JAX ``train_split`` and of the port's on reduced
    mamba2-1.3b, from the same params and tokens: per-step losses and the
    final tower and server params at 1e-4, the port's step 0 verified
    against its serial protocol_step at 1e-5 in the run."""
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    kw = dict(steps=STEPS, batch=BATCH, seq=SEQ, runtime=runtime,
              microbatches=microbatches, print_fn=lambda *a: None)
    jout, jmetrics, _ = jax_train_split(
        jcfg, JaxLMBatchLoader(jcfg, BATCH, SEQ, seed=0), verify_step0=False,
        **kw)
    lines = []
    out, metrics, _ = train_split(
        cfg, LMBatchLoader(cfg, BATCH, SEQ, seed=0), device="cpu",
        params=setup["params"], **dict(kw, print_fn=lines.append))
    np.testing.assert_allclose(metrics.losses, jmetrics.losses, **RUN_TOL)
    assert metrics.steps == list(range(STEPS))
    assert metrics.step0_max_dgrad is not None and \
        metrics.step0_max_dgrad <= 1e-5
    assert any("step-0 verification" in line for line in lines)
    _close(out["towers"], jout["towers"], RUN_TOL)
    _close(out["server"], jout["server"], RUN_TOL)
