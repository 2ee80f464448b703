"""The port's plain ``merge_pool`` and ``fast_merge`` against the JAX
package's Pallas kernel (interpret mode) and its jnp oracle.

Same inputs, made from a seed with numpy, go through both packages.
Tolerances are those of tests/test_kernels.py: 1e-5 in f32, 2e-2 in bf16
(the Pallas kernel accumulates in f32, the oracles in the input dtype).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.merge_pool import merge_pool as jax_merge_pool
from repro.runtime.executor import fast_merge as jax_fast_merge
from repro_torch.interop import tensor_from_numpy, to_numpy
from repro_torch.kernels import merge_pool as kernel_module
from repro_torch.kernels import ops, ref
from repro_torch.runtime.executor import fast_merge

STRATEGIES = ["sum", "avg", "max", "mul", "concat"]
SHAPES = [(2, 8, 128), (4, 32, 256), (5, 100, 384), (3, 37, 100),
          (4, 1, 960)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(k, b, d, dtype, live_kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((k, b, d)).astype(np.float32)
    if live_kind == "all":
        live = np.ones((k,), np.float32)
    elif live_kind == "dropped":
        live = np.ones((k,), np.float32)
        live[rng.integers(1, k)] = 0.0  # one client dropped, client 0 live
    else:  # every client dropped
        live = np.zeros((k,), np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx, jnp.asarray(live), torch.from_numpy(live)


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        rtol=tol, atol=tol)


@pytest.mark.parametrize("live_kind", ["all", "dropped", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k,b,d", SHAPES)
def test_plain_merge_pool_matches_jax(k, b, d, strategy, dtype, live_kind):
    seed = k * 1000 + b * 10 + d
    jx, tx, jlive, tlive = _inputs(k, b, d, dtype, live_kind, seed)
    got = to_numpy(ops.merge_pool(tx, tlive, strategy=strategy))
    out_d = k * d if strategy == "concat" else d
    assert got.shape == (b, out_d)
    assert np.all(np.isfinite(got))
    pallas = jax_merge_pool(jx, jlive, strategy=strategy, interpret=True)
    _close(got, pallas.astype(jnp.float32), dtype)
    oracle = jax_ref.merge_pool(jx, strategy, jlive)
    _close(got, oracle.astype(jnp.float32), dtype)
    if live_kind == "none" and strategy in ("max", "concat", "sum", "avg"):
        assert not np.any(got)  # all dropped: zeros (avg divides by 1)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shape", [(4, 1, 7, 96), (2, 2, 5, 64),
                                   (4, 1, 1, 960)])
def test_fast_merge_matches_jax(shape, strategy):
    """(K, B, S, D) stacks are flattened around the kernel and restored."""
    x = np.random.default_rng(len(shape) + shape[-1]).standard_normal(
        shape).astype(np.float32)
    got = to_numpy(fast_merge(torch.from_numpy(x), strategy))
    want = np.asarray(jax_fast_merge(jnp.asarray(x), strategy))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_version():
    """On the CPU the dispatch runs the plain version and never reaches the
    kernel wrapper (whose counters stay untouched)."""
    before = dict(kernel_module.launches)
    x = tensor_from_numpy(np.ones((2, 3, 4), np.float32), "cpu")
    out = ops.merge_pool(x, strategy="avg")
    assert torch.equal(out, ref.merge_pool(x, "avg"))
    assert kernel_module.launches == before
