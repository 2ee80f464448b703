"""The port's plain ``merge_pool`` and ``fast_merge`` against the JAX
package's Pallas kernel (interpret mode) and its jnp oracle, forward and
backward.

Same inputs, made from a seed with numpy, go through both packages.
Forward tolerances are those of tests/test_kernels.py: 1e-5 in f32, 2e-2
in bf16 (the Pallas kernel accumulates in f32, the oracles in the input
dtype).  Backward: 1e-5 in f32, 5e-2 in bf16 (a gradient is rounded to
bf16 once more than the merged value it came from).  The backward runs
through the port's ``MergePool`` autograd Function (its plain versions
on the CPU) and is held to ``jax.vjp`` of the Pallas ``custom_vjp``
(interpret mode) and of the jnp oracle — except mul at an exact zero,
where the Pallas formula ``out / x_k`` gives 0/0 and the port is held to
autodiff of the oracle alone.
"""
import jax
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
GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}


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


@pytest.mark.parametrize("strategy", ["sum", "avg", "max", "mul"])
def test_reduce_wrapper_refuses_cpu_tensors_without_building(monkeypatch,
                                                            strategy):
    """The reductions' forward is the CUDA C++ kernel ``repro_merge_reduce``
    (an entry of the library's ctypes signatures, taking the stack, the
    live flags, the output, n = B * D, K, strategy, dtype, device and
    stream).  A CPU stack is refused before the library is built or
    loaded, and no launch is counted."""
    from repro_torch.kernels import build

    argtypes, restype = build.SIGNATURES["repro_merge_reduce"]
    assert len(argtypes) == 9 and restype is not None
    assert "merge_pool.cu" in [p.name for p in build.sources()]

    def no_build():
        raise AssertionError("the library was built for a CPU tensor")

    monkeypatch.setattr(build, "library", no_build)
    monkeypatch.setattr(build, "build", no_build)
    before = dict(kernel_module.launches)
    x = torch.ones((3, 2, 5))
    with pytest.raises(ValueError, match="CUDA"):
        kernel_module.merge_pool(x, torch.ones(3), strategy=strategy)
    assert kernel_module.launches == before


@pytest.mark.parametrize("strategy", ["sum", "avg", "max", "mul"])
def test_reduce_bwd_wrapper_refuses_cpu_tensors_without_building(
        monkeypatch, strategy):
    """The reductions' backward is the CUDA C++ kernel
    ``repro_merge_reduce_bwd`` (an entry of the library's ctypes
    signatures, taking the gradient, the live flags, the stack, the
    forward output, the stack's gradient, n = B * D, K, strategy, dtype,
    device and stream).  A CPU gradient is refused before the library is
    built or loaded, and no launch is counted."""
    from repro_torch.kernels import build

    argtypes, restype = build.SIGNATURES["repro_merge_reduce_bwd"]
    assert len(argtypes) == 11 and restype is not None

    def no_build(*_):
        raise AssertionError("the library was built for a CPU tensor")

    monkeypatch.setattr(build, "library", no_build)
    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "entry", no_build)
    before = dict(kernel_module.launches)
    x = torch.ones((3, 2, 5))
    with pytest.raises(ValueError, match="CUDA"):
        kernel_module.merge_pool_bwd(x, torch.ones(3), torch.ones((2, 5)),
                                     torch.ones((2, 5)), strategy=strategy)
    assert kernel_module.launches == before


def test_port_has_no_triton():
    """Every kernel of the port is CUDA C++ on the ctypes route: no module
    under ``src/repro_torch`` imports ``triton``, at any depth of the
    module (a lazy import inside a function included)."""
    import ast
    from pathlib import Path

    import repro_torch

    files = sorted(Path(repro_torch.__file__).parent.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(name.split(".")[0] == "triton" for name in names), \
                (path, node.lineno)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_concat_wrappers_refuse_cpu_tensors_without_building(monkeypatch,
                                                             direction):
    """The concat merge and its backward are the CUDA C++ kernels
    ``repro_merge_concat`` (stack, live, output, B, D, K, dtype, device,
    stream) and ``repro_merge_concat_bwd`` (live, gradient, stack
    gradient, B, D, K, dtype, device, stream).  A CPU tensor is refused
    before the library is built or loaded, and no launch is counted."""
    from repro_torch.kernels import build

    entry = {"forward": "repro_merge_concat",
             "backward": "repro_merge_concat_bwd"}[direction]
    argtypes, restype = build.SIGNATURES[entry]
    assert len(argtypes) == 9 and restype is not None

    def no_build(*_):
        raise AssertionError("the library was built for a CPU tensor")

    monkeypatch.setattr(build, "library", no_build)
    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "entry", no_build)
    before = dict(kernel_module.launches)
    with pytest.raises(ValueError, match="CUDA"):
        if direction == "forward":
            kernel_module.merge_pool(torch.ones((3, 2, 5)), torch.ones(3),
                                     strategy="concat")
        else:
            kernel_module.concat_bwd(torch.ones(3), torch.ones((2, 15)), k=3)
    assert kernel_module.launches == before


def _c_entry_points():
    """{name: parameter count} of every function defined inside an
    ``extern "C"`` block of the CUDA sources."""
    import re

    from repro_torch.kernels import build

    found = {}
    for path in build.sources():
        text = path.read_text()
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"',
                                text, re.S):
            for name, params in re.findall(
                    r"^[A-Za-z_][\w ]*?\**\s*\b(repro_\w+)\(([^)]*)\)\s*\{",
                    block, re.M):
                found[name] = len([p for p in params.split(",") if p.strip()])
    return found


def test_every_c_entry_point_has_its_signature():
    """Every ``extern "C"`` function of ``csrc/*.cu`` has a ctypes
    signature in ``build.SIGNATURES`` with as many arguments, and every
    signature names such a function: a pointer or a stream passed without
    one would be cut to 32 bits."""
    from repro_torch.kernels import build

    found = _c_entry_points()
    assert {"repro_merge_reduce", "repro_merge_reduce_bwd",
            "repro_merge_concat", "repro_merge_concat_bwd",
            "repro_flash_attention", "repro_ssd_chunk"} <= set(found)
    assert found == {name: len(argtypes)
                     for name, (argtypes, _) in build.SIGNATURES.items()}


def _port_vjp(x, live, g, strategy):
    """The port's gradient of the merge w.r.t. the stack, through
    ``ops.merge_pool`` (MergePool on the CPU)."""
    x = x.detach().clone().requires_grad_(True)
    out = ops.merge_pool(x, live, strategy=strategy)
    grad, = torch.autograd.grad(out, x, g)
    return to_numpy(grad)


def _jax_vjps(jx, jlive, jg, strategy, pallas=True):
    def vjp(fn):
        _, pull = jax.vjp(fn, jx)
        return np.asarray(pull(jg)[0].astype(jnp.float32))

    want = {"oracle": vjp(lambda s: jax_ref.merge_pool(s, strategy, jlive))}
    if pallas:
        want["pallas"] = vjp(lambda s: jax_merge_pool(
            s, jlive, strategy=strategy, interpret=True))
    return want


@pytest.mark.parametrize("live_kind", ["all", "dropped", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k,b,d", [(2, 8, 128), (3, 37, 100)])
def test_merge_pool_backward_matches_jax(k, b, d, strategy, dtype, live_kind):
    """Jacobian splitting: the port's backward equals jax.vjp of the Pallas
    kernel and of the oracle — every strategy, f32 and bf16, one client
    dropped, all dropped, the ragged (3, 37, 100)."""
    seed = 7 + k * 1000 + b * 10 + d
    jx, tx, jlive, tlive = _inputs(k, b, d, dtype, live_kind, seed)
    out_d = k * d if strategy == "concat" else d
    g = np.random.default_rng(seed + 1).standard_normal(
        (b, out_d)).astype(np.float32)
    jg = jnp.asarray(g).astype(jx.dtype)
    tg = torch.from_numpy(g).to(tx.dtype)
    got = _port_vjp(tx, tlive, tg, strategy)
    assert got.shape == (k, b, d) and np.all(np.isfinite(got))
    for want in _jax_vjps(jx, jlive, jg, strategy).values():
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL[dtype],
                                   atol=GRAD_TOL[dtype])
    if live_kind == "none":
        assert not np.any(got)  # every client dropped: no gradient


def test_mul_backward_at_an_exact_zero():
    """A live client holding an exact 0: the port gives each client the
    product of the others (autodiff of the oracle), finite everywhere;
    the Pallas ``out / x_k`` formula gives NaN there."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 16)).astype(np.float32)
    x[1, 2, 5] = 0.0
    x[2, 4, :3] = 0.0  # a zero in a second client elsewhere
    live = np.array([1, 1, 1, 0], np.float32)
    g = rng.standard_normal((6, 16)).astype(np.float32)
    got = _port_vjp(torch.from_numpy(x), torch.from_numpy(live),
                    torch.from_numpy(g), "mul")
    want = _jax_vjps(jnp.asarray(x), jnp.asarray(live), jnp.asarray(g),
                     "mul", pallas=False)["oracle"]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # client 1's gradient at its own zero is the product of the others
    others = x[0, 2, 5] * x[2, 2, 5]
    np.testing.assert_allclose(got[1, 2, 5], g[2, 5] * others, rtol=1e-6)
    pallas = _jax_vjps(jnp.asarray(x), jnp.asarray(live), jnp.asarray(g),
                       "mul")["pallas"]
    assert np.isnan(pallas[1, 2, 5])


def test_max_backward_splits_ties():
    """Exact ties among live clients split the credit equally, as
    autodiff does; a dropped client holding the same value gets none."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 5, 8)).astype(np.float32)
    x[1] = x[0]          # clients 0 and 1 tie everywhere
    x[3] = x[0] + 10.0   # client 3 would win, but is dropped
    x[2, 0, :] = x[0, 0, :]  # a three-way tie in row 0
    live = np.array([1, 1, 1, 0], np.float32)
    g = rng.standard_normal((5, 8)).astype(np.float32)
    got = _port_vjp(torch.from_numpy(x), torch.from_numpy(live),
                    torch.from_numpy(g), "max")
    for want in _jax_vjps(jnp.asarray(x), jnp.asarray(live), jnp.asarray(g),
                          "max").values():
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, 0].sum(0), g[0], rtol=1e-6)
    assert not np.any(got[3])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fast_merge_backward_matches_jax(strategy):
    """Through ``fast_merge``'s reshape of a (K, B, S, D) stack and a loss
    that broadcasts (the gradient reaching MergePool is strided):
    ``torch.autograd.grad`` equals ``jax.grad`` of the JAX fast_merge."""
    x = np.random.default_rng(11).standard_normal(
        (4, 2, 5, 24)).astype(np.float32)
    w = np.random.default_rng(12).standard_normal(
        (96 if strategy == "concat" else 24,)).astype(np.float32)

    tx = torch.from_numpy(x).requires_grad_(True)
    loss = (fast_merge(tx, strategy) * torch.from_numpy(w)).sum()
    got, = torch.autograd.grad(loss, tx)
    want = jax.grad(lambda s: jnp.sum(jax_fast_merge(s, strategy) * w))(
        jnp.asarray(x))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_plain_switch_keeps_pytorch_autograd():
    """``use_kernel=False`` is the plain version with PyTorch's own
    autograd, equal to the MergePool path on the CPU."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 4, 8)).astype(np.float32))
    g = torch.ones((4, 8))
    for strategy in STRATEGIES[:-1]:
        a = _port_vjp(x, None, g, strategy)
        xp = x.clone().requires_grad_(True)
        b, = torch.autograd.grad(
            ops.merge_pool(xp, strategy=strategy, use_kernel=False), xp, g)
        np.testing.assert_allclose(a, to_numpy(b), rtol=1e-6, atol=1e-6)
