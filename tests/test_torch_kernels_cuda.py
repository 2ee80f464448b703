"""The port's Triton kernels against their plain PyTorch version.

The kernels run only on a CUDA card: tests that launch them carry the
``cuda`` marker and skip without one.  This file imports neither jax nor
the JAX package, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: 1e-5 in f32, 2e-2 in bf16 (the kernels accumulate in f32, the
plain version in the input dtype).
"""
import pytest
import torch

from repro_torch.kernels import merge_pool as kernel_module
from repro_torch.kernels import ops, ref

STRATEGIES = ["sum", "avg", "max", "mul", "concat"]
SHAPES = [(2, 8, 128), (4, 32, 256), (5, 100, 384), (3, 37, 100),
          (4, 1, 960), (4, 1024, 960), (4, 128, 240)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _live(k, kind):
    live = torch.ones(k, dtype=torch.float32, device="cuda")
    if kind == "dropped":
        live[k - 1] = 0.0
    elif kind == "none":
        live.zero_()
    return live


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: there is no fallback."""
    x = torch.ones((2, 3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        kernel_module.merge_pool(x, strategy="sum")
    with pytest.raises(ValueError, match="unknown merge"):
        ops.merge_pool(x, strategy="median")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_kernels_match_plain_version_on_card(strategy, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Triton kernels run only there)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    name = ("merge_concat_kernel" if strategy == "concat"
            else "merge_reduce_kernel")
    for kind in ("all", "dropped", "none"):
        for shape in SHAPES:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            live = _live(shape[0], kind)
            before = kernel_module.launches[name]
            got = ops.merge_pool(x, live, strategy=strategy)
            assert kernel_module.launches[name] == before + 1
            want = ref.merge_pool(x, strategy, live)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == x.dtype
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
def test_kernel_wrapper_validates_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Triton kernels run only there)")
    x = torch.randn(4, 8, 16, device="cuda")
    with pytest.raises(TypeError, match="dtype"):
        kernel_module.merge_pool(x.half(), strategy="avg")
    with pytest.raises(ValueError, match="contiguous"):
        kernel_module.merge_pool(x.transpose(1, 2), strategy="avg")
    with pytest.raises(ValueError, match=r"\(K, B, D\)"):
        kernel_module.merge_pool(x[0], strategy="avg")
    with pytest.raises(ValueError, match="live"):
        kernel_module.merge_pool(x, torch.ones(3, device="cuda"),
                                 strategy="avg")
