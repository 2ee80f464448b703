"""Activation rematerialization (``backbone.forward(remat=...)``) against
the port's own forward without it and against the JAX package's
``jax.grad`` of ``forward(remat=...)``: the dense family split and
centralized, the ssm family and the hybrid family (zamba2-7b at 6 layers,
every 2: two super-blocks, each a unit with its Mamba2 layers nested in
it, and a tail).  ``tests/test_torch_remat_families.py`` runs the moe,
audio and vlm families through the helpers here (a file each, so that
each runs in well under a minute: the JAX package compiles each
gradient).

- For ``remat`` True and ``"dots"``: the loss and every gradient leaf
  equal the port's ``remat=False`` ones bit for bit (the recompute runs
  the same ops on the same inputs), and match the JAX package's within
  1e-5 (``tests/test_torch_ssd_train.py``'s gradient tolerance; ``A_log``
  within 1e-4, its tolerance for A's gradient).
- The units are the JAX package's scan bodies: a stack's layer (a
  tower's, the server's, the encoder's, the decoder's), a hybrid's
  super-block and each Mamba2 layer nested in it, one
  ``torch.utils.checkpoint`` call each, and none without remat.
- The checkpoint is applied layer by layer: under ``remat=True`` one more
  layer keeps exactly one more layer input (``B * S * d_model`` f32) in
  the autograd graph, counted by an outer ``saved_tensors_hooks``, and
  many times that without remat.
- ``"dots"`` keeps the weight products: its backward pass runs no more
  ``aten.mm`` than the pass without remat, while ``True`` runs the
  layers' products again; both re-run the same elementwise work.
- The kernels' Functions recompute: ``ops.FlashAttention`` (its forward
  with the logsumexp) and ``ops.SSDChunk`` run their forward again in a
  unit's recompute and their backward once, with the same gradients;
  a model step runs the SSD forward twice a layer, three times in a
  hybrid super-block's nested Mamba2 units.

Inputs: the JAX package's seeded init carried across by ``interop`` and
numpy tokens (frames, patches) from one seed.  f32.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_arch as jax_get_arch
from repro.models import backbone as jax_backbone
from repro_torch.configs.base import get_arch
from repro_torch.interop import params_from_numpy, to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import backbone
from repro_torch.models import transformer as tfm
from repro_torch.tree_util import tree_leaves, tree_unflatten

GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
A_GRAD_TOL = dict(rtol=1e-5, atol=1e-4)
REMATS = [True, "dots"]
B, S = 2, 64  # two chunks of the reduced ssm configs' 32
# case -> (arch, vertical, {field: value} replaced in both configs)
CASES = {
    "dense-vertical": ("smollm-360m", True, {}),
    "dense-centralized": ("smollm-360m", False, {}),
    "ssm": ("mamba2-1.3b", True, {}),
    "hybrid": ("zamba2-7b", True, {"num_layers": 6, "every": 2}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def configs(arch: str, vertical: bool = True, num_layers=None, every=None):
    """Both packages' reduced configs, cut alike."""
    out = []
    for cfg in (jax_get_arch(arch).reduced(), get_arch(arch).reduced()):
        if num_layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=num_layers)
        if every is not None:
            cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
                cfg.hybrid, shared_attn_every=every))
        out.append(cfg if vertical else cfg.with_vertical(None))
    return out


def numpy_batch(cfg, seed: int = 0) -> dict:
    """Tokens and next-token labels, plus an audio config's frames or a
    vlm config's patches."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family == "audio":
        batch["frames"] = (rng.standard_normal(
            (B, cfg.encdec.encoder_seq_len, cfg.d_model)) * 0.5).astype(
                np.float32)
    if cfg.family == "vlm":
        batch["patches"] = (rng.standard_normal(
            (B, cfg.vlm.num_vision_tokens, cfg.d_model)) * 0.5).astype(
                np.float32)
    return batch


def make_setup(jcfg, cfg) -> dict:
    jparams = jax.jit(jax_backbone.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    batch = numpy_batch(cfg)
    setup = dict(jcfg=jcfg, cfg=cfg, jparams=jparams, batch=batch,
                 params=params_from_numpy(
                     jax.tree_util.tree_map(np.asarray, jparams), "cpu"))
    setup["plain"] = port_loss_and_grads(setup, False)
    return setup


def port_loss_and_grads(setup: dict, remat):
    """The reference's dry-run step up to the update: ``forward(remat=)``,
    ``lm_loss + aux``, the gradient of every leaf (None where the forward
    reads none)."""
    params, cfg = setup["params"], setup["cfg"]
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    logits, aux = backbone.forward(tree_unflatten(params, leaves), batch,
                                   cfg, remat=remat)
    loss = backbone.lm_loss(logits, batch["labels"]) + aux
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads


def jax_loss_and_grads(setup: dict, remat):
    jcfg = setup["jcfg"]
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}

    def loss_fn(p):
        logits, aux = jax_backbone.forward(p, batch, jcfg, remat=remat)
        return jax_backbone.lm_loss(logits, batch["labels"]) + aux

    return jax.jit(jax.value_and_grad(loss_fn))(setup["jparams"])


def _named(tree, path=()):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _named(tree[key], path + (key,))
    elif tree is not None:
        yield "/".join(path), tree


def check_bit_equal(setup: dict, remat) -> None:
    loss, grads = port_loss_and_grads(setup, remat)
    want_loss, want = setup["plain"]
    assert torch.equal(loss, want_loss)
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert (g is None) == (w is None), i
        assert g is None or torch.equal(g, w), \
            f"leaf {i} {tuple(g.shape)}: max |diff| {(g - w).abs().max()}"


def check_against_jax(setup: dict, remat) -> None:
    loss, grads = port_loss_and_grads(setup, remat)
    jloss, jgrads = jax_loss_and_grads(setup, remat)
    np.testing.assert_allclose(float(loss), float(jloss), **GRAD_TOL)
    params = setup["params"]
    got = to_numpy(tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(tree_leaves(params), grads)]))
    got, want = dict(_named(got)), dict(_named(
        jax.tree_util.tree_map(np.asarray, jgrads)))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        tol = A_GRAD_TOL if name.endswith("A_log") else GRAD_TOL
        np.testing.assert_allclose(g, want[name], err_msg=name, **tol)


# the param subtrees stacked (L, ...) whose every layer is one unit
STACKS = ("server", "server_dense", "server_tail", "encoder", "decoder",
          "vision_tower", "text_tower")


def _lead(tree) -> tuple:
    while isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return tuple(tree.shape)


def reference_units(params: dict) -> int:
    """The JAX package's checkpointed scan bodies a forward runs: one per
    layer of each stack, K * Lt for the towers, and for each hybrid
    super-block the block and its ``every`` nested Mamba2 layers."""
    units = 0
    for key, sub in params.items():
        if sub is None:
            continue
        if key == "towers":
            K, Lt = _lead(sub["blocks"])[:2]
            units += K * Lt
        elif key == "server_super":
            n_super, every = _lead(sub)[:2]
            units += n_super * (1 + every)
        elif key in STACKS:
            units += _lead(sub)[0]
    return units


def check_units(setup: dict) -> None:
    """Checkpoint calls in the forward (the backward pass calls a nested
    unit's checkpoint again when it recomputes the enclosing one)."""
    params, cfg = setup["params"], setup["cfg"]
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    units = reference_units(params)
    for remat, want in ((False, 0), (True, units), ("dots", units)):
        with mock.patch.object(tfm.ckpt, "checkpoint",
                               wraps=tfm.ckpt.checkpoint) as spy:
            backbone.forward(params, batch, cfg, remat=remat)
        assert spy.call_count == want, (remat, spy.call_count, want)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, vertical, cut = CASES[request.param]
    return make_setup(*configs(arch, vertical, **cut))


@pytest.mark.parametrize("remat", REMATS, ids=["full", "dots"])
def test_remat_equals_no_remat_bit_for_bit(case, remat):
    check_bit_equal(case, remat)


@pytest.mark.parametrize("remat", REMATS, ids=["full", "dots"])
def test_remat_matches_jax(case, remat):
    check_against_jax(case, remat)


def test_units_are_the_reference_scan_bodies(case):
    check_units(case)


def _saved_bytes(cfg, layers: int, remat) -> int:
    """Bytes the autograd graph of ``forward`` + ``lm_loss`` keeps, over
    tensors that share no storage with a parameter, as the outer hook
    sees them (a checkpoint's own hook takes what its unit saves)."""
    cfg = dataclasses.replace(cfg, num_layers=layers)
    params = backbone.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    owned = {t.untyped_storage().data_ptr() for t in leaves}
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(cfg).items()}
    saved = []

    def pack(t):
        if t.untyped_storage().data_ptr() not in owned:
            saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, aux = backbone.forward(params, batch, cfg, remat=remat)
        backbone.lm_loss(logits, batch["labels"]) + aux
    return sum(saved)


@pytest.mark.parametrize("arch,every", [("smollm-360m", None),
                                        ("mamba2-1.3b", None),
                                        ("zamba2-7b", 1)],
                         ids=["dense", "ssm", "hybrid"])
def test_checkpoint_keeps_one_input_per_layer(arch, every):
    """Centralized, so that every layer is a server layer (a hybrid's
    every 1: one more layer is one more super-block, whose nested Mamba2
    unit saves into the super-block's checkpoint)."""
    _, cfg = configs(arch, vertical=False, every=every)
    layer_input = B * S * cfg.d_model * 4
    grows = {remat: _saved_bytes(cfg, 3, remat) - _saved_bytes(cfg, 2, remat)
             for remat in (True, False)}
    assert grows[True] == layer_input
    assert grows[False] > 4 * layer_input


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_weight_products():
    """The backward pass's op counts on the reduced centralized dense
    model: ``"dots"`` runs as many ``mm`` as no remat (the saved products
    are read back, not recomputed) and as many multiplies as full remat
    (the elementwise work is recomputed)."""
    _, cfg = configs("smollm-360m", vertical=False)
    params = backbone.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(cfg).items()}
    mm, mul = {}, {}
    for remat in (False, True, "dots"):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        logits, aux = backbone.forward(tree_unflatten(params, leaves), batch,
                                       cfg, remat=remat)
        loss = backbone.lm_loss(logits, batch["labels"]) + aux
        with _OpCount() as ops:
            torch.autograd.grad(loss, leaves)
        mm[remat] = ops.counts.get(torch.ops.aten.mm.default, 0)
        mul[remat] = ops.counts.get(torch.ops.aten.mul.Tensor, 0)
    assert mm["dots"] == mm[False] < mm[True]
    assert mul["dots"] == mul[True] > mul[False]


def _grad_of(fn, inputs, remat):
    """Gradients of ``fn(*inputs).square().sum()`` with ``fn`` one unit."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = tfm._maybe_checkpoint(fn, remat)(*leaves)
    return torch.autograd.grad(out.square().sum(), leaves)


@pytest.mark.parametrize("remat", [False] + REMATS, ids=["none", "full",
                                                         "dots"])
def test_kernel_functions_recompute_in_a_unit(remat):
    """``ops.FlashAttention`` and ``ops.SSDChunk`` inside a unit: the
    forward with its logsumexp and the chunk forward run again in the
    recompute (the checkpoint's check that the recompute saves as many
    tensors of the same shapes passes), each backward once, and the
    gradients equal those without remat bit for bit.  Weight products
    before each, so that ``"dots"`` has products to keep."""
    rng = np.random.default_rng(0)

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.5)

    S, D = 96, 32
    attn_in = [arr(1, S, 64), arr(64, 6 * D), arr(64, 2 * D), arr(64, 2 * D)]

    def attention(x, wq, wk, wv):
        q, k, v = (torch.matmul(x, w).reshape(1, S, -1, D).transpose(1, 2)
                   for w in (wq, wk, wv))
        return ops.flash_attention(q, k, v, causal=True)

    Bsz, H, P, N, chunk = 2, 3, 8, 16, 32
    ssd_in = [arr(Bsz, S, 16), arr(16, H * P), arr(Bsz, S, H), arr(H),
              arr(Bsz, S, 1, N), arr(Bsz, S, 1, N)]

    def scan(u, w, dt, a, Bm, Cm):
        x = torch.matmul(u, w).reshape(Bsz, S, H, P)
        return ops.ssd_scan(x, torch.nn.functional.softplus(dt), -torch.exp(a),
                            Bm, Cm, chunk)[0]

    runs = 2 if remat else 1
    for fn, inputs, fwd, bwd in (
            (attention, attn_in, "flash_attention_lse",
             "flash_attention_bwd"),
            (scan, ssd_in, "ssd_chunks", "ssd_chunks_bwd")):
        with mock.patch.object(ref, fwd, wraps=getattr(ref, fwd)) as f, \
                mock.patch.object(ref, bwd, wraps=getattr(ref, bwd)) as b:
            grads = _grad_of(fn, inputs, remat)
        assert (f.call_count, b.call_count) == (runs, 1), fwd
        for g, w in zip(grads, _grad_of(fn, inputs, False)):
            assert torch.equal(g, w), fwd


@pytest.mark.parametrize("arch,every,want", [
    ("mamba2-1.3b", None, {False: 3, True: 6, "dots": 6}),
    ("zamba2-7b", 2, {False: 7, True: 18, "dots": 18})],
    ids=["ssm", "hybrid"])
def test_ssd_forwards_per_step(arch, every, want):
    """SSD chunk forwards in one step of the reduced model (split, the
    hybrid at 6 layers: two super-blocks of 2 Mamba2 layers, one tail
    layer, two tower layers): each layer's unit runs it again in the
    recompute; a super-block's nested Mamba2 units run it a third time
    (the block's recompute runs them as units, which their own backward
    recomputes).  The backward runs once a layer.  ``chip_smoke.py``
    phase 20 counts these launches on the card."""
    _, cfg = configs(arch, num_layers=6 if every else None, every=every)
    params = backbone.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in numpy_batch(cfg).items()}
    for remat, n in want.items():
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        with mock.patch.object(ops.SSDChunk, "forward",
                               wraps=ops.SSDChunk.forward) as fwd, \
                mock.patch.object(ops.SSDChunk, "backward",
                                  wraps=ops.SSDChunk.backward) as bwd:
            logits, aux = backbone.forward(tree_unflatten(params, leaves),
                                           batch, cfg, remat=remat)
            torch.autograd.grad(backbone.lm_loss(logits, batch["labels"])
                                + aux, leaves, allow_unused=True)
        assert (fwd.call_count, bwd.call_count) == (n, want[False]), remat
