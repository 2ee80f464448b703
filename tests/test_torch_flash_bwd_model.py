"""A numpy model of the CUDA flash backward's order of work
(``kernels/csrc/flash_attention_bwd.cu``), held on the CPU to ``jax.vjp``
of the JAX package's attention oracle, as
``tests/test_torch_ssd_bwd_model.py`` models the SSD backward.

The kernel runs only on a card; its plain twin
(``ref.flash_attention_bwd``) computes the gradient row block by row
block.  The model follows the kernel instead, in f32: Delta first; then
per (batch, kv head, 64-row kv tile) dK and dV, summed over the group's
q heads in order and, for each, the q tiles at or below the diagonal;
then per (batch, q head, 64-row q tile) dQ over the kv tiles up to the
diagonal; P recomputed from the forward's logsumexp at each use; every
mask the kernel applies (causal, rows and columns past S).  Held at 1e-5
at every tile edge.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ref

TILE = 64  # the kernel's q and kv tile rows


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, B, H, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, S, D)).astype(np.float32)
            for h in (H, Hkv, Hkv, H)]


def _jax_vjp(q, k, v, do, causal):
    """``jax.vjp`` of the reference's oracle (kv heads repeated) at (q, k,
    v) pulled back from dO."""
    rep = q.shape[1] // k.shape[1]

    @jax.jit
    def run(q, k, v, do):
        _, pull = jax.vjp(lambda q, k, v: jax_ref.flash_attention(
            q, jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1),
            causal=causal), q, k, v)
        return pull(do)

    return [np.asarray(g) for g in run(*map(jnp.asarray, (q, k, v, do)))]


# ---------------------------------------------------------------------------
# a numpy model of the kernel's order of work
# ---------------------------------------------------------------------------

def _kernel_model(q, k, v, o, lse, do, causal):
    """The CUDA backward's work in its order, in f32 numpy: Delta; then per
    (batch, kv head, kv tile) dK and dV summed over the group's q heads in
    order and, for each, the q tiles at or below the diagonal; then per
    (batch, q head, q tile) dQ over the kv tiles up to the diagonal.  P is
    recomputed from lse at each use, masked to 0 (causal, rows and
    columns past S), tiles wholly above the diagonal never visited."""
    f32 = np.float32
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    group = H // Hkv
    scale = f32(1.0 / np.sqrt(f32(D)))
    n = -(-S // TILE)
    delta = np.sum(do * o, axis=-1, dtype=f32)

    def tile(b, h, i, j):
        rows = np.arange(i * TILE, min((i + 1) * TILE, S))
        cols = np.arange(j * TILE, min((j + 1) * TILE, S))
        hk = h // group
        s = q[b, h, rows] @ k[b, hk, cols].T
        p = np.exp(s * scale - lse[b, h, rows, None]).astype(f32)
        if causal:
            p = np.where(cols[None, :] > rows[:, None], f32(0), p)
        dp = do[b, h, rows] @ v[b, hk, cols].T
        return rows, cols, p, p * (dp - delta[b, h, rows, None])

    dq = np.zeros_like(q)
    dk = np.zeros_like(k)
    dv = np.zeros_like(v)
    visited = 0
    for b in range(B):
        for hk in range(Hkv):
            for j in range(n):
                acc_k = np.zeros((min(TILE, S - j * TILE), D), f32)
                acc_v = np.zeros_like(acc_k)
                for h in range(hk * group, (hk + 1) * group):
                    for i in range(j if causal else 0, n):
                        rows, cols, p, ds = tile(b, h, i, j)
                        acc_v += p.T @ do[b, h, rows]
                        acc_k += ds.T @ q[b, h, rows]
                        visited += 1
                dk[b, hk, cols] = acc_k * scale
                dv[b, hk, cols] = acc_v
        for h in range(H):
            for i in range(n):
                acc = np.zeros((min(TILE, S - i * TILE), D), f32)
                for j in range(i + 1 if causal else n):
                    rows, cols, p, ds = tile(b, h, i, j)
                    acc += ds @ k[b, h // group, cols]
                dq[b, h, rows] = acc * scale
    want_visits = B * H * (n * (n + 1) // 2 if causal else n * n)
    assert visited == want_visits
    return dq, dk, dv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("H,Hkv,D", [(3, 1, 32), (4, 2, 80)])
def test_kernel_order_model_matches_jax_vjp(H, Hkv, D, S, causal):
    """The kernel's order of work, modelled in numpy, equals ``jax.vjp`` of
    the reference's oracle at 1e-5 at every tile edge (S 1, 63, 64, 65)
    and past a tile (200), groups of 3 and 2."""
    shape = (2, H, Hkv, S, D)
    q, k, v, do = _inputs(S * H + D, *shape)
    o, lse = ref.flash_attention_lse(*(torch.from_numpy(a)
                                       for a in (q, k, v)), causal=causal)
    got = _kernel_model(q, k, v, o.numpy(), lse.numpy(), do, causal)
    want = _jax_vjp(q, k, v, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} S={S} causal={causal}")
