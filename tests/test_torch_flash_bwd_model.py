"""The CUDA flash backward's order of work
(``kernels/csrc/flash_attention_bwd.cu``), held on the CPU to ``jax.vjp``
of the JAX package's attention oracle, as
``tests/test_torch_ssd_bwd_model.py`` models the SSD backward.

The kernels run only on a card; their plain twin
(``ref.flash_attention_bwd``) computes the gradient row block by row
block.  The numpy model of ``tests/test_torch_flash_bwd_wgmma.py``
follows the kernels instead: Delta first; then per (batch, q head, kv
block) each warpgroup's 64 kv rows over the q tiles at or below the
diagonal, dK and dV written as that head's partials; the partials of each
kv head's group summed in head order (the reduce pass); then per (batch,
q head, q block) each warpgroup's 64 q rows over the kv tiles up to the
diagonal; P recomputed from the forward's logsumexp at each use; every
mask the kernels apply (causal, rows and columns past S).  Here it runs
with exact f32 products (its "exact" route), so the schedule alone is
held, at 1e-5, at every tile edge.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ref
from test_torch_flash_bwd_wgmma import _kernel_model


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
    got = _kernel_model(q, k, v, o.numpy(), lse.numpy(), do, causal,
                        "exact")
    want = _jax_vjp(q, k, v, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} S={S} causal={causal}")
