"""The port's attention backward against the JAX package, on the CPU.

The JAX package has no backward kernel for attention: it differentiates
its plain chunked attention (``repro.models.attention.
chunked_flash_attention``) with ``jax.grad``.  The port's flash backward
(``kernels/csrc/flash_attention_bwd.cu``, CUDA only) has a plain twin,
``kernels/ref.flash_attention_bwd``, which the CPU runs and the card's
kernel is held to.  Here, with inputs made from numpy seeds and handed to
both packages:

* ``ref.flash_attention_bwd`` against ``jax.vjp`` of the reference's
  chunked attention and of its oracle ``repro.kernels.ref.
  flash_attention`` (kv heads repeated), at S 64, 200 and 2304, GQA
  groups 1, 3 and 12, head dims 32, 64, 80 and 128, causal and full: f32
  at 1e-5, bf16 inputs at 3e-2 (the forward's bf16 tolerance);
* the logsumexp of ``ref.flash_attention_lse`` (what the forward kernel
  writes for the backward) against ``jax.nn.logsumexp`` of the
  reference's scaled, masked scores, at 1e-5;
* ``ops.FlashAttention`` on the CPU against PyTorch autograd of
  ``ref.flash_attention``, and ``ops.flash_attention`` taking it exactly
  when an input requires grad.

A numpy model of the CUDA kernel's order of work is in
``tests/test_torch_flash_bwd_model.py``; reduced training past 2048
tokens against the JAX package in ``tests/test_torch_flash_bwd_train.py``
(monolithic) and ``tests/test_torch_flash_bwd_split.py`` (split).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attn
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ops, ref

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, B, H, Hkv, S, D):
    """q, k, v and the output's gradient dO, f32 numpy, (B, heads, S, D)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    do = rng.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v, do


def _jax_chunked(causal, S):
    """The reference's chunked attention as a function of (B, H, S, D)
    inputs, with the chunks its attention_apply picks."""
    chunk = jax_attn._pick_chunk(S, 512)
    pos = jnp.arange(S, dtype=jnp.int32)

    def fn(q, k, v):
        out = jax_attn.chunked_flash_attention(
            *(jnp.swapaxes(t, 1, 2) for t in (q, k, v)), causal=causal,
            q_positions=pos, kv_positions=pos, q_chunk=chunk,
            kv_chunk=chunk)
        return jnp.swapaxes(out, 1, 2)

    return fn


def _jax_oracle(causal, rep):
    def fn(q, k, v):
        return jax_ref.flash_attention(q, jnp.repeat(k, rep, axis=1),
                                       jnp.repeat(v, rep, axis=1),
                                       causal=causal)

    return fn


def _jax_vjp(fn, arrays, dtype):
    """``jax.vjp`` of ``fn`` at (q, k, v) pulled back from dO, as f32
    numpy."""
    q, k, v, do = (jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays)

    @jax.jit
    def run(q, k, v, do):
        _, pull = jax.vjp(fn, q, k, v)
        return pull(do)

    return [np.asarray(g.astype(jnp.float32)) for g in run(q, k, v, do)]


def _port_bwd(arrays, causal, dtype):
    """The port's forward with its logsumexp, then its plain backward, in
    ``dtype``; the gradients as f32 numpy."""
    q, k, v, do = (torch.from_numpy(a).to(TORCH_DTYPES[dtype])
                   for a in arrays)
    o, lse = ref.flash_attention_lse(q, k, v, causal=causal)
    grads = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for g, t in zip(grads, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype
    return [g.float().numpy() for g in grads]


# (B, H, Hkv, S, D): S 64, 200 and 2304; groups 1, 3 and 12; every head
# dim of the list at each of the short lengths
BWD_SHAPES = [(2, 1, 1, 64, 32), (2, 3, 1, 64, 64), (1, 12, 1, 64, 80),
              (2, 2, 2, 64, 128), (1, 3, 1, 200, 32), (1, 12, 1, 200, 128),
              (2, 4, 4, 200, 80), (1, 6, 2, 200, 64), (1, 1, 1, 2304, 64),
              (1, 3, 1, 2304, 32)]


# bf16 inputs at one shape per head dim, group and length
BWD_BF16_SHAPES = [BWD_SHAPES[i] for i in (1, 5, 6, 9)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape,dtype", [
    *((s, "float32") for s in BWD_SHAPES),
    *((s, "bfloat16") for s in BWD_BF16_SHAPES)])
def test_plain_backward_matches_jax_vjp(shape, dtype, causal):
    """``ref.flash_attention_bwd`` equals ``jax.vjp`` of the reference's
    chunked attention and of its oracle: dq, dk and dv (dk and dv summed
    over each kv head's group of q heads)."""
    B, H, Hkv, S, D = shape
    arrays = _inputs(S * D + H, *shape)
    got = _port_bwd(arrays, causal, dtype)
    tol = TOL[dtype]
    for fn in (_jax_chunked(causal, S), _jax_oracle(causal, H // Hkv)):
        want = _jax_vjp(fn, arrays, dtype)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{name} {shape} {causal}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 1, 65, 32), (1, 4, 2, 300, 64),
                                   (1, 2, 1, 2304, 128)])
def test_lse_matches_jax_logsumexp(shape, causal):
    """The logsumexp the forward returns for the backward: the reference's
    scores scaled by 1/sqrt(D), masked at -1e30 above the diagonal,
    ``jax.nn.logsumexp`` over each row; and the output beside it equals
    ``ref.flash_attention``'s."""
    B, H, Hkv, S, D = shape
    q, k, v, _ = _inputs(S + D, *shape)
    s = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q),
                   jnp.repeat(jnp.asarray(k), H // Hkv, axis=1)) / np.sqrt(
                       np.float32(D))
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool)), s, -1e30)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = ref.flash_attention_lse(tq, tk, tv, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(o, ref.flash_attention(tq, tk, tv,
                                                      causal=causal),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_matches_autograd_on_cpu(causal, dtype):
    """``ops.FlashAttention`` (the plain forward with its logsumexp and the
    plain backward on the CPU) against PyTorch autograd of
    ``ref.flash_attention``: the output exactly, the gradients at the
    dtype's tolerance, on the model's layout (transposed views)."""
    q, k, v, do = _inputs(11, 2, 6, 2, 150, 32)

    def leaves():
        return [torch.from_numpy(a).to(TORCH_DTYPES[dtype]).transpose(
            1, 2).contiguous().transpose(1, 2).requires_grad_(True)
            for a in (q, k, v)]

    g = torch.from_numpy(do).to(TORCH_DTYPES[dtype])
    ours, theirs = leaves(), leaves()
    out = ops.FlashAttention.apply(*ours, causal)
    want = ref.flash_attention(*theirs, causal=causal)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    got_g = torch.autograd.grad(out, ours, g)
    want_g = torch.autograd.grad(want, theirs, g)
    tol = TOL[dtype]
    for a, b in zip(got_g, want_g):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


def test_flash_dispatch_takes_the_function_under_grad_only():
    """``ops.flash_attention`` goes through ``FlashAttention`` when an input
    requires grad (and grad is enabled), else runs the plain forward with
    no graph; no kernel is counted on the CPU."""
    q, k, v, _ = _inputs(3, 1, 4, 2, 40, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    flash_kernel.reset_launches()
    plain = ops.flash_attention(tq, tk, tv, causal=True)
    assert plain.grad_fn is None
    tq.requires_grad_(True)
    out = ops.flash_attention(tq, tk, tv, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert ops.flash_attention(tq, tk, tv, causal=True).grad_fn is None
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
    out.sum().backward()
    assert tq.grad is not None and tk.grad is None
    assert all(n == 0 for n in flash_kernel.launches.values())
    assert all(n == 0 for n in flash_kernel.bwd_launches.values())


def test_backward_wrapper_refuses_cpu_tensors():
    """The backward kernel's wrapper takes CUDA tensors only: there is no
    fallback to the plain version."""
    q = torch.ones((1, 2, 8, 64))
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention_bwd(q, q, q, q, lse, q, causal=True)
