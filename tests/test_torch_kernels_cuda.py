"""The port's kernels — the four merge kernels, the flash-attention
kernel forward and backward and the SSD chunk kernel, all CUDA C++ —
against their plain PyTorch versions.

The kernels run only on a CUDA card: tests that launch them carry the
``cuda`` marker and skip without one.  This file imports neither jax nor
the JAX package, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: 1e-5 in f32, 2e-2 in bf16 forward (the kernels accumulate in
f32, the plain forward in the input dtype), 5e-2 in bf16 backward (both
compute in f32; a gradient is rounded to bf16 once more than the merged
value it came from).  Flash attention: 5e-4 in f32 and 3e-2 in bf16, the
JAX package's own tolerances for its Pallas kernel; the flash backward
within 1e-4 (f32) and 2e-2 (bf16) of the call's largest plain gradient;
the SSD chunk kernel: 3e-4 in f32, likewise.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as flash_module
from repro_torch.kernels import merge_pool as kernel_module
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd_module
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba

STRATEGIES = ["sum", "avg", "max", "mul", "concat"]
SHAPES = [(2, 8, 128), (4, 32, 256), (5, 100, 384), (3, 37, 100),
          (4, 1, 960), (4, 1024, 960), (4, 128, 240)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
BWD_NAME = {"concat": "merge_concat_bwd_kernel"}


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
        pytest.skip("needs a CUDA device (the merge kernels run only there)")
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
        pytest.skip("needs a CUDA device (the merge kernels run only there)")
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


# (K, B, D): runs of B * D that are not a multiple of 4 (the scalar path),
# B = 1, and K past the templated client counts (the runtime-K path)
EDGE_SHAPES = [(3, 5, 7), (2, 1, 3), (4, 1, 6), (5, 3, 9), (4, 1, 960),
               (10, 4, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strategy", ["sum", "avg", "max", "mul"])
def test_reduce_kernel_edges_on_card(strategy, dtype):
    """The CUDA C++ reduction at its edges: ragged runs, B = 1, a dropped
    client, every client dropped, a stack that starts off a 16-byte
    boundary, K = 10, and max with exact ties (a tied dropped client
    included).  One launch per call, counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the merge kernel runs only there)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    for shape in EDGE_SHAPES:
        n = shape[0] * shape[1] * shape[2]
        flat = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
        for x in (flat[:n].view(shape), flat[1:].view(shape)):
            for kind in ("all", "dropped", "none"):
                live = _live(shape[0], kind)
                before = kernel_module.launches["merge_reduce_kernel"]
                got = kernel_module.merge_pool(x, live, strategy=strategy)
                assert kernel_module.launches["merge_reduce_kernel"] == \
                    before + 1
                want = ref.merge_pool(x, strategy, live)
                torch.cuda.synchronize()
                assert got.shape == want.shape and got.dtype == dtype
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=TOL[dtype], atol=TOL[dtype])
    t = torch.randn((4, 3, 10), generator=gen, device="cuda").to(dtype)
    t[1] = t[0]
    t[3] = t[0]
    live = torch.tensor([1.0, 1.0, 1.0, 0.0], device="cuda")
    got = kernel_module.merge_pool(t, live, strategy=strategy)
    torch.testing.assert_close(got.float(),
                               ref.merge_pool(t, strategy, live).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


# (K, B, D) for the concat kernels' scalar path: D % 4 != 0, B = 1, K = 10
CONCAT_EDGE_SHAPES = [(10, 3, 7), (4, 1, 7), (10, 1, 240), (3, 5, 6),
                      (1, 2, 1)]


def _concat_pair(x, live, g):
    """Both concat directions, kernel and plain, one launch each."""
    K = x.shape[0]
    counts = dict(kernel_module.launches)
    got = (kernel_module.merge_pool(x, live, strategy="concat"),
           kernel_module.concat_bwd(live, g, k=K))
    assert kernel_module.launches["merge_concat_kernel"] == \
        counts["merge_concat_kernel"] + 1
    assert kernel_module.launches["merge_concat_bwd_kernel"] == \
        counts["merge_concat_bwd_kernel"] + 1
    want = (ref.merge_pool(x, "concat", live), ref.concat_bwd(live, g, K))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_concat_kernels_edges_on_card(dtype):
    """The CUDA C++ concat merge and its backward at their edges, both
    bit-identical to the plain versions (a product by 0.0 or 1.0 is exact,
    and so is the bf16 round trip): the scalar path (D % 4 != 0, B = 1,
    K = 10), operands that start off a vector boundary (contiguous views
    at an odd storage offset), a dropped client, every client dropped;
    and a NaN in a dropped client's slice gives NaN where the plain
    versions give it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the merge kernels run only there)")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape in CONCAT_EDGE_SHAPES + [(4, 128, 240)]:
        K, B, D = shape
        n = K * B * D
        fx = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
        fg = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
        for start in (0, 1):
            x = fx[start:start + n].view(shape)
            g = fg[start:start + n].view(B, K * D)
            for kind in ("all", "dropped", "none"):
                live = _live(K, kind)
                for got, want in zip(*_concat_pair(x, live, g)):
                    assert got.shape == want.shape and got.dtype == dtype
                    assert torch.equal(got, want), (shape, start, kind)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn((B, K * D), generator=gen, device="cuda").to(dtype)
        x[K - 1, 0, 0] = float("nan")
        x[K - 1, B - 1, D - 1] = float("inf")
        g[0, (K - 1) * D] = float("nan")
        g[B - 1, K * D - 1] = float("-inf")
        live = _live(K, "dropped")
        for got, want in zip(*_concat_pair(x, live, g)):
            nan = torch.isnan(want)
            assert nan.any() and torch.equal(torch.isnan(got), nan)
            assert torch.equal(got[~nan], want[~nan])


def _plain_grad(x, live, g, strategy):
    """The plain backward, through PyTorch's autograd of the plain merge."""
    xp = x.detach().clone().requires_grad_(True)
    grad, = torch.autograd.grad(ref.merge_pool(xp, strategy, live), xp, g)
    return grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_backward_kernels_match_plain_version_on_card(strategy, dtype):
    """MergePool's backward launches the backward kernel once per call and
    equals the plain backward (the ref functions and autograd of the plain
    merge), for every live mask and shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the merge kernels run only there)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    name = BWD_NAME.get(strategy, "merge_reduce_bwd_kernel")
    for kind in ("all", "dropped", "none"):
        for shape in SHAPES:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            live = _live(shape[0], kind)
            xk = x.clone().requires_grad_(True)
            out = ops.merge_pool(xk, live, strategy=strategy)
            g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
            before = kernel_module.launches[name]
            got, = torch.autograd.grad(out, xk, g)
            assert kernel_module.launches[name] == before + 1
            if strategy == "concat":
                plain = ref.concat_bwd(live, g, shape[0])
            else:
                plain = ref.merge_pool_bwd(x, live, out.detach(), g, strategy)
            torch.cuda.synchronize()
            assert got.shape == x.shape and got.dtype == dtype
            for want in (plain, _plain_grad(x, live, g, strategy)):
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=GRAD_TOL[dtype],
                                           atol=GRAD_TOL[dtype])


@pytest.mark.cuda
def test_backward_kernel_edge_cases_on_card():
    """mul with an exact zero in a live client (the product of the others,
    finite), max with exact ties (the credit split), and a strided
    gradient reaching the Function through fast_merge's reshape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the merge kernels run only there)")
    from repro_torch.runtime.executor import fast_merge

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((4, 6, 16), generator=gen, device="cuda")
    x[1, 2, 5] = 0.0
    live = torch.tensor([1.0, 1.0, 1.0, 0.0], device="cuda")
    g = torch.randn((6, 16), generator=gen, device="cuda")
    got = kernel_module.merge_pool_bwd(x, live, None, g, strategy="mul")
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, _plain_grad(x, live, g, "mul"),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1, 2, 5], g[2, 5] * x[0, 2, 5] * x[2, 2, 5])

    t = torch.randn((4, 5, 8), generator=gen, device="cuda")
    t[1] = t[0]
    t[3] = t[0] + 10.0  # would win, but is dropped
    gt = torch.randn((5, 8), generator=gen, device="cuda")
    out = kernel_module.merge_pool(t, live, strategy="max")
    got = kernel_module.merge_pool_bwd(t, live, out, gt, strategy="max")
    torch.testing.assert_close(got, _plain_grad(t, live, gt, "max"),
                               rtol=1e-6, atol=1e-6)
    assert not got[3].any()

    for strategy in STRATEGIES:
        s = torch.randn((4, 2, 5, 24), generator=gen, device="cuda")
        w = torch.randn((96 if strategy == "concat" else 24,),
                        generator=gen, device="cuda")
        sk = s.clone().requires_grad_(True)
        got, = torch.autograd.grad((fast_merge(sk, strategy) * w).sum(), sk)
        sp = s.clone().requires_grad_(True)
        want, = torch.autograd.grad(
            (fast_merge(sp, strategy, use_kernel=False) * w).sum(), sp)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# (K, B, D) for the reductions' backward: K = 1, 3, 8 and 10 (the
# runtime-K instantiation), D = 7 and B = 1 (the scalar path)
REDUCE_BWD_EDGE_SHAPES = [(1, 3, 8), (3, 5, 7), (8, 4, 12), (10, 3, 8),
                          (4, 1, 7), (8, 1, 960), (10, 1, 7)]


def _reduce_bwd_pair(x, live, out, g, strategy):
    """The reductions' backward, kernel and plain, one launch counted."""
    before = kernel_module.launches["merge_reduce_bwd_kernel"]
    got = kernel_module.merge_pool_bwd(x, live, out, g, strategy=strategy)
    assert kernel_module.launches["merge_reduce_bwd_kernel"] == before + 1
    want = ref.merge_pool_bwd(x, live, out, g, strategy)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want


def _expect_reduce_bwd(got, want, strategy, dtype):
    """sum, avg and max bit-identical to the plain backward (the same f32
    operations, one rounding to the dtype), NaN where it has NaN; mul
    within the backward tolerance (its products may round in another
    order than the plain version's cumprods)."""
    if strategy == "mul":
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=GRAD_TOL[dtype], atol=GRAD_TOL[dtype],
                                   equal_nan=True)
        return
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_bwd_kernel_edges_on_card(dtype):
    """The CUDA C++ reductions' backward at its edges: K = 1, 3, 8, 10, the
    scalar path (D = 7, B = 1), g, the stack and the forward output as
    contiguous views at storage offset 1, a dropped client, every client
    dropped; a NaN and an Inf in a dropped client reach no other client's
    max or mul gradient, and a NaN in g gives NaN where the plain sum and
    avg give it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the merge kernels run only there)")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for shape in REDUCE_BWD_EDGE_SHAPES:
        K, B, D = shape
        n = K * B * D
        fx = torch.randn(n + 1, generator=gen, device="cuda").to(dtype)
        fg = torch.randn(B * D + 1, generator=gen, device="cuda").to(dtype)
        for start in (0, 1):
            x = fx[start:start + n].view(shape)
            g = fg[start:start + B * D].view(B, D)
            for kind in ("all", "dropped", "none"):
                live = _live(K, kind)
                for strategy in ("sum", "avg", "max", "mul"):
                    fo = torch.empty(B * D + 1, device="cuda", dtype=dtype)
                    out = fo[start:start + B * D].view(B, D)
                    out.copy_(kernel_module.merge_pool(x, live,
                                                       strategy=strategy))
                    got, want = _reduce_bwd_pair(x, live, out, g, strategy)
                    _expect_reduce_bwd(got, want, strategy, dtype)
        if K == 1:
            continue
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = torch.randn((B, D), generator=gen, device="cuda").to(dtype)
        live = _live(K, "dropped")
        x[K - 1, 0, 0] = float("nan")
        x[K - 1, B - 1, D - 1] = float("inf")
        for strategy in ("max", "mul"):
            out = kernel_module.merge_pool(x, live, strategy=strategy)
            got, want = _reduce_bwd_pair(x, live, out, g, strategy)
            assert torch.isfinite(got).all() and torch.isfinite(want).all()
            _expect_reduce_bwd(got, want, strategy, dtype)
        g[0, 0] = float("nan")
        for strategy in ("sum", "avg"):
            got, want = _reduce_bwd_pair(None, live, None, g, strategy)
            assert torch.isnan(want).any()
            _expect_reduce_bwd(got, want, strategy, dtype)


# the paper MLP's cut stacks: PhraseBank (K 4, cut 64) at batch 256 and at
# a quarter of it (its 4-microbatch run), Bank Marketing / Give Me Some
# Credit (K 2, cut 16) at batch 256
MLP_SHAPES = [(4, 256, 64), (4, 64, 64), (2, 256, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MLP_SHAPES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_merge_kernels_at_mlp_shapes_on_card(strategy, shape):
    """Forward and backward at the MLP shapes, every live mask, with half
    the rows tied between clients 0 and 1 (max splits their credit):
    concat both ways and the sum, avg and max backward bit-identical to
    the plain versions, the rest within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the merge kernels run only there)")
    gen = torch.Generator(device="cuda").manual_seed(4)
    K, B, _ = shape
    fwd_name = ("merge_concat_kernel" if strategy == "concat"
                else "merge_reduce_kernel")
    bwd_name = BWD_NAME.get(strategy, "merge_reduce_bwd_kernel")
    exact = strategy in ("concat", "sum", "avg", "max")
    for kind in ("all", "dropped", "none"):
        x = torch.randn(shape, generator=gen, device="cuda")
        x[1, :B // 2] = x[0, :B // 2]
        live = _live(K, kind)
        xk = x.clone().requires_grad_(True)
        before = dict(kernel_module.launches)
        out = ops.merge_pool(xk, live, strategy=strategy)
        g = torch.randn(out.shape, generator=gen, device="cuda")
        got, = torch.autograd.grad(out, xk, g)
        want_out = ref.merge_pool(x, strategy, live)
        if strategy == "concat":
            want = ref.concat_bwd(live, g, K)
        else:
            want = ref.merge_pool_bwd(x, live, want_out, g, strategy)
        torch.cuda.synchronize()
        assert kernel_module.launches[fwd_name] == before[fwd_name] + 1
        assert kernel_module.launches[bwd_name] == before[bwd_name] + 1
        tol = TOL[torch.float32]
        torch.testing.assert_close(out.detach(), want_out, rtol=0 if
                                   strategy == "concat" else tol,
                                   atol=0 if strategy == "concat" else tol)
        torch.testing.assert_close(got, want, rtol=0 if exact else tol,
                                   atol=0 if exact else tol)
        torch.testing.assert_close(got, _plain_grad(x, live, g, strategy),
                                   rtol=GRAD_TOL[torch.float32],
                                   atol=GRAD_TOL[torch.float32])
        if strategy == "max" and kind == "all":
            # a tied element's credit is split in half between the clients
            tied = x[0, :B // 2] == want_out[:B // 2]
            assert tied.any()
            half = g[:B // 2] / 2
            torch.testing.assert_close(got[0, :B // 2][tied], half[tied],
                                       rtol=0, atol=0)
            torch.testing.assert_close(got[1, :B // 2][tied], half[tied],
                                       rtol=0, atol=0)


@pytest.mark.cuda
def test_backward_wrappers_validate_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the merge kernels run only there)")
    live = torch.ones(4, device="cuda")
    g = torch.randn(8, 16, device="cuda")
    with pytest.raises(ValueError, match="reads the stack"):
        kernel_module.merge_pool_bwd(None, live, None, g, strategy="mul")
    with pytest.raises(ValueError, match="forward output"):
        kernel_module.merge_pool_bwd(torch.randn(4, 8, 16, device="cuda"),
                                     live, None, g, strategy="max")
    with pytest.raises(ValueError, match="contiguous"):
        kernel_module.merge_pool_bwd(None, live, None,
                                     torch.randn(16, 8, device="cuda").T,
                                     strategy="avg")
    with pytest.raises(TypeError, match="dtype"):
        kernel_module.concat_bwd(live, g.half(), k=4)
    with pytest.raises(ValueError, match="CUDA"):
        kernel_module.concat_bwd(live.cpu(), g.cpu(), k=4)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: 5e-4, torch.bfloat16: 3e-2}
# (B, H, Hkv, S, D): ragged small shapes, then the serving path's tower
# and server shapes past the 2048-token threshold: smollm-360m's (D 64),
# starcoder2-3b's (D 128), stablelm-3b's server (D 80) and zamba2-7b's
# shared attention (D 112)
FLASH_SHAPES = [(2, 4, 2, 37, 64), (1, 2, 2, 600, 32), (2, 3, 3, 128, 32),
                (1, 3, 1, 2500, 64), (1, 15, 5, 2500, 64),
                (2, 4, 2, 37, 128), (1, 4, 4, 600, 80), (2, 3, 3, 129, 112),
                (1, 6, 1, 2500, 128), (1, 24, 2, 2500, 128),
                (1, 32, 32, 2100, 80), (1, 32, 32, 2100, 112)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash kernel runs only there)")


def _qkv(shape, dtype, gen, layout="bhsd"):
    B, H, Hkv, S, D = shape
    if layout == "bshd":  # the model's layout, passed as transposed views
        return [torch.randn((B, S, h, D), generator=gen, device="cuda"
                            ).to(dtype).transpose(1, 2) for h in (H, Hkv, Hkv)]
    return [torch.randn((B, h, S, D), generator=gen, device="cuda").to(dtype)
            for h in (H, Hkv, Hkv)]


def test_flash_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: there is no fallback."""
    q = torch.ones((1, 2, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_module.flash_attention(q, q, q, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernel_matches_plain_version_on_card(shape, causal, dtype):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(shape[3])
    for layout in ("bhsd", "bshd"):
        q, k, v = _qkv(shape, dtype, gen, layout)
        before = flash_module.launches["flash_attention_kernel"]
        before_d = flash_module.launches_by_instance[(shape[4], dtype)]
        got = ops.flash_attention(q, k, v, causal=causal)
        assert flash_module.launches["flash_attention_kernel"] == before + 1
        assert flash_module.launches_by_instance[(shape[4], dtype)] == \
            before_d + 1
        want = ref.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert got.shape == q.shape and got.dtype == dtype
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=FLASH_TOL[dtype],
                                   atol=FLASH_TOL[dtype])


# every edge of the 32- and 64-row kv tiles, the 64-row warpgroups, the
# 128-row q tiles and the 16-row warp slabs
FLASH_EDGE_SEQS = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 2500, 31, 32,
                   33, 95, 96, 97]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80, 112, 128])
@pytest.mark.parametrize("s", FLASH_EDGE_SEQS)
def test_flash_kernel_tile_edges_on_card(s, d):
    """The tensor-core kernel against ref.flash_attention at every tile
    edge: groups of 1 and 3 q heads per kv head, causal and full, both
    layouts, f32 within 5e-4 and bf16 within 3e-2."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(s * d)
    for shape in ((2, 2, 2, s, d), (1, 6, 2, s, d)):
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                for layout in ("bhsd", "bshd"):
                    q, k, v = _qkv(shape, dtype, gen, layout)
                    got = flash_module.flash_attention(q, k, v,
                                                       causal=causal)
                    want = ref.flash_attention(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    assert got.shape == q.shape and got.dtype == dtype
                    assert torch.isfinite(got).all()
                    torch.testing.assert_close(
                        got.float(), want.float(), rtol=FLASH_TOL[dtype],
                        atol=FLASH_TOL[dtype],
                        msg=lambda m: f"{shape} causal={causal} {dtype} "
                        f"{layout}: {m}")


@pytest.mark.cuda
def test_flash_kernel_matches_chunked_model_path_on_card():
    """Past the threshold, attention_apply's kernel branch equals its plain
    chunked branch (use_kernel=False) on the same card."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    d_model, H, Hkv, hd, S = 96, 3, 1, 32, 2304
    params = {name: torch.randn(shape, generator=gen, device="cuda") * 0.1
              for name, shape in (("wq", (d_model, H * hd)),
                                  ("wk", (d_model, Hkv * hd)),
                                  ("wv", (d_model, Hkv * hd)),
                                  ("wo", (H * hd, d_model)))}
    x = torch.randn((1, S, d_model), generator=gen, device="cuda")
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd)
    before = flash_module.launches["flash_attention_kernel"]
    got, _ = attn_lib.attention_apply(params, x, **kw)
    assert flash_module.launches["flash_attention_kernel"] == before + 1
    want, _ = attn_lib.attention_apply(params, x, use_kernel=False, **kw)
    assert flash_module.launches["flash_attention_kernel"] == before + 1
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
def test_flash_kernel_refusals_on_card():
    """No silent fallback on the card: positions other than one contiguous
    run ``p0 + arange(S)`` (the vlm text tower runs at ``Sv +
    arange(S)``), a window, a cross attention whose query and key lengths
    differ, and anything the kernels do not take raise.  Grad-requiring
    inputs train through the backward kernels; under ``no_grad`` the
    forward runs alone."""
    _needs_card()
    q = torch.randn((1, 4, 100, 64), device="cuda")
    k = torch.randn((1, 2, 100, 64), device="cuda")
    flash_module.reset_launches()
    out = ops.flash_attention(q.requires_grad_(True), k, k, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    q = q.detach()
    with torch.no_grad():
        assert ops.flash_attention(q.requires_grad_(True), k, k,
                                   causal=True).grad_fn is None
    assert flash_module.launches["flash_attention_kernel"] == 2
    assert all(n == 0 for n in flash_module.bwd_launches.values())
    q = q.detach()
    lse = torch.zeros((1, 4, 100), device="cuda")
    with pytest.raises(ValueError, match="lse"):
        flash_module.flash_attention_bwd(q, k, k, q, lse[..., :50], q,
                                         causal=True)
    with pytest.raises(ValueError, match="q's shape"):
        flash_module.flash_attention_bwd(q, k, k, q[:, :, :50], lse, q,
                                         causal=True)
    with pytest.raises(TypeError, match="dtype"):
        flash_module.flash_attention_bwd(q, k, k, q, lse, q.bfloat16(),
                                         causal=True)
    with pytest.raises(ValueError, match="head dim"):
        flash_module.flash_attention(q[..., :48], k[..., :48], k[..., :48],
                                     causal=True)
    with pytest.raises(TypeError, match="dtype"):
        flash_module.flash_attention(q, k.bfloat16(), k, causal=True)
    with pytest.raises(ValueError, match="groups"):
        flash_module.flash_attention(q, torch.randn((1, 3, 100, 64),
                                                    device="cuda"),
                                     torch.randn((1, 3, 100, 64),
                                                 device="cuda"), causal=True)
    with pytest.raises(ValueError, match="contiguous last"):
        flash_module.flash_attention(
            q, torch.randn((1, 2, 100, 128), device="cuda")[..., ::2], k,
            causal=True)
    with pytest.raises(ValueError, match=r"\(B, Hkv, S, D\)"):
        flash_module.flash_attention(q, k[:, :, :50], k[:, :, :50],
                                     causal=True)

    params = {name: torch.randn(shape, device="cuda")
              for name, shape in (("wq", (64, 64)), ("wk", (64, 64)),
                                  ("wv", (64, 64)), ("wo", (64, 64)))}
    x = torch.randn((1, 2049, 64), device="cuda")
    kw = dict(n_heads=1, n_kv_heads=1, head_dim=64)
    gap = torch.arange(2049, device="cuda")
    gap[1000:] += 1
    with pytest.raises(NotImplementedError, match="contiguous run"):
        attn_lib.attention_apply(params, x, positions=gap, **kw)
    with pytest.raises(NotImplementedError, match="windowed attention"):
        attn_lib.attention_apply(params, x, window=256, **kw)
    enc = torch.randn((1, 3000, 1, 64), device="cuda")
    with pytest.raises(NotImplementedError, match="cross attention"):
        attn_lib.attention_apply(
            params, x, causal=False, rope_theta=None, kv_override=(
                enc, enc, torch.arange(3000, device="cuda")), **kw)
    for start in (0, 5):
        out, _ = attn_lib.attention_apply(
            params, x, positions=start + torch.arange(2049, device="cuda"),
            **kw)
        assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------

# dq, dk and dv against the plain backward: the largest |kernel - plain|
# over the call's largest plain gradient entry (at S = 1 dq and dk are
# rounding noise about an exact 0: P = 1 makes dS = dP - Delta).  The
# lengths straddle the kernels' tiles (16, 32 and 64 rows) and blocks (64
# and 128 rows)
FLASH_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLASH_BWD_EDGE_SEQS = [1, 15, 16, 17, 31, 33, 63, 64, 65, 127, 128, 129,
                       2304]


def _flash_bwd_case(shape, dtype, gen, causal):
    """The backward's arguments: q, k, v in the model's layout, the
    kernel forward's output and logsumexp, and a random dO."""
    q, k, v = _qkv(shape, dtype, gen, "bshd")
    o, lse = flash_module.flash_attention(q, k, v, causal=causal,
                                          return_lse=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, o, lse, do


def _flash_bwd_error(got, want) -> float:
    scale = max(float(w.float().abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.isfinite(g.float()).all()
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want)) / scale


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80, 112, 128])
@pytest.mark.parametrize("s", FLASH_BWD_EDGE_SEQS)
def test_flash_bwd_kernel_matches_plain_version_on_card(s, d):
    """The backward kernels against ref.flash_attention_bwd at every head
    dim and dtype, at the tiles' and blocks' edges and at 2304: groups of
    1 and 3 q heads per kv head, causal and full; one launch of each
    kernel per call, counted by instance."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    for shape in ((2, 2, 2, s, d), (1, 6, 2, s, d)):
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                args = _flash_bwd_case(shape, dtype, gen, causal)
                before = dict(flash_module.bwd_launches)
                before_i = flash_module.bwd_launches_by_instance[(d, dtype)]
                got = flash_module.flash_attention_bwd(*args, causal=causal)
                assert all(flash_module.bwd_launches[n] == before[n] + 1
                           for n in flash_module.BWD_KERNELS)
                assert flash_module.bwd_launches_by_instance[(d, dtype)] == \
                    before_i + 1
                want = ref.flash_attention_bwd(*args, causal=causal)
                torch.cuda.synchronize()
                err = _flash_bwd_error(got, want)
                assert err <= FLASH_BWD_REL[dtype], \
                    f"{shape} causal={causal} {dtype}: {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((1, 48, 8, 2304, 128), torch.bfloat16),   # internvl2-26b, group 6
    ((1, 56, 8, 2304, 128), torch.bfloat16),   # arctic-480b, group 7
    ((1, 64, 8, 2304, 128), torch.bfloat16),   # qwen3-32b, group 8
    ((2, 3, 1, 2304, 64), torch.float32),      # smollm-360m's towers
    ((2, 3, 1, 2304, 64), torch.bfloat16)])
def test_flash_bwd_kernel_sums_large_groups_on_card(shape, dtype):
    """The reduce pass sums each kv head's group of q-head partials: the
    configs' groups of 6, 7 and 8 at D = 128 in bf16 and the towers' one
    kv head for 3 q heads, causal and full, against the plain backward."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(shape[1])
    for causal in (True, False):
        args = _flash_bwd_case(shape, dtype, gen, causal)
        got = flash_module.flash_attention_bwd(*args, causal=causal)
        want = ref.flash_attention_bwd(*args, causal=causal)
        torch.cuda.synchronize()
        err = _flash_bwd_error(got, want)
        assert err <= FLASH_BWD_REL[dtype], \
            f"{shape} causal={causal} {dtype}: {err:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_is_deterministic_on_card(dtype):
    """No atomics: two launches on the same inputs give the same bits, at
    the server's shape of smollm-360m (15 q / 5 kv heads)."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    args = _flash_bwd_case((1, 15, 5, 2304, 64), dtype, gen, True)
    first = flash_module.flash_attention_bwd(*args, causal=True)
    second = flash_module.flash_attention_bwd(*args, causal=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_bwd_plan_on_card():
    """The launch plan the library reports at the two training shapes in
    f32 at D = 64: two warpgroups (128 rows) a block and 32-row tiles,
    one dkdv and one dq block per (batch, q head, row block), the reduce
    pass on at most eight blocks an SM of this card; a length of one
    tile plus one row still takes a whole block."""
    _needs_card()
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for B, H, Hkv, S in ((2, 15, 5, 4096), (2, 3, 1, 4096), (1, 3, 1, 33)):
        plan = flash_module.bwd_plan(B, H, Hkv, S, 64, torch.float32, device)
        assert (plan["block_rows"], plan["tile_rows"]) == (128, 32)
        assert plan["sms"] == sms
        assert plan["blocks"] == B * H * -(-S // 128)
        assert plan["longest_tiles"] == -(-S // 32)
        want = min(B * Hkv * S * 16 // 256 + 1, 8 * sms)
        assert plan["reduce_blocks"] == want
        assert plan["heads_per_sum"] == H // Hkv


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80, 112, 128])
def test_flash_kernel_lse_matches_plain_version_on_card(d):
    """The forward kernel's logsumexp against ref.flash_attention_lse, f32
    and bf16, causal and full; the output beside it equals the output
    without it, bit for bit."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(d)
    for S in (1, 65, 2304):
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = _qkv((1, 6, 2, S, d), dtype, gen, "bshd")
                o, lse = flash_module.flash_attention(
                    q, k, v, causal=causal, return_lse=True)
                plain = flash_module.flash_attention(q, k, v, causal=causal)
                _, want = ref.flash_attention_lse(q, k, v, causal=causal)
                torch.cuda.synchronize()
                assert lse.dtype == torch.float32 and \
                    lse.shape == (1, 6, S)
                assert torch.equal(o, plain)
                torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_grad_requiring_flash_attention_launches_the_backward_on_card():
    """Past the threshold, attention_apply under autograd runs the flash
    forward once and the four backward kernels once, never the plain
    version, and its gradients equal those of the plain chunked path
    (use_kernel=False) on the same card."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    d_model, H, Hkv, hd, S = 96, 3, 1, 32, 2304
    params = {name: (torch.randn(shape, generator=gen, device="cuda") * 0.1
                     ).requires_grad_(True)
              for name, shape in (("wq", (d_model, H * hd)),
                                  ("wk", (d_model, Hkv * hd)),
                                  ("wv", (d_model, Hkv * hd)),
                                  ("wo", (H * hd, d_model)))}
    x = torch.randn((1, S, d_model), generator=gen, device="cuda")
    w = torch.randn((1, S, d_model), generator=gen, device="cuda")
    kw = dict(n_heads=H, n_kv_heads=Hkv, head_dim=hd)
    leaves = list(params.values())
    flash_module.reset_launches()
    out, _ = attn_lib.attention_apply(params, x, **kw)
    got = torch.autograd.grad((out * w).sum(), leaves)
    assert flash_module.launches["flash_attention_kernel"] == 1
    assert flash_module.bwd_launches == dict.fromkeys(
        flash_module.BWD_KERNELS, 1)
    assert flash_module.bwd_launches_by_instance[(hd, torch.float32)] == 1
    plain, _ = attn_lib.attention_apply(params, x, use_kernel=False, **kw)
    want = torch.autograd.grad((plain * w).sum(), leaves)
    assert flash_module.launches["flash_attention_kernel"] == 1
    assert flash_module.bwd_launches == dict.fromkeys(
        flash_module.BWD_KERNELS, 1)
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=1e-3, atol=1e-3 * float(
            p.abs().max()))


# ---------------------------------------------------------------------------
# the SSD chunk kernel
# ---------------------------------------------------------------------------

SSD_TOL = dict(rtol=3e-4, atol=3e-4)
# (B, S, H, P, N, chunk): the server and tower shapes of mamba2-1.3b at a
# short length, a prompt shorter than a chunk, the reduced config's chunks,
# the JAX package's own test shapes, d_state staged 16 columns at a time,
# d_state past one block's 128 state columns, a chunk that is not a
# multiple of 8, a one-token prompt, and 201 heads (a last head group that
# is not full)
SSD_SHAPES = [(1, 512, 64, 64, 128, 128), (2, 256, 16, 64, 128, 128),
              (2, 96, 4, 64, 128, 128), (1, 128, 4, 64, 16, 32),
              (2, 64, 2, 16, 16, 16), (2, 128, 2, 32, 32, 32),
              (1, 192, 3, 64, 48, 64), (1, 256, 4, 64, 256, 128),
              (2, 200, 3, 32, 64, 100), (1, 1, 2, 16, 16, 128),
              (1, 64, 201, 16, 16, 64)]


def _ssd_inputs(shape, gen):
    """The JAX package's test distributions; B and C as the model passes
    them: strided views of the conv output ``[x, B, C]``."""
    B, S, H, P, N, _ = shape
    x = torch.randn((B, S, H, P), generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda") * 0.5)
    A = -torch.exp(torch.randn((H,), generator=gen, device="cuda") * 0.3)
    u = torch.randn((B, S, H * P + 2 * N), generator=gen, device="cuda") * 0.3
    Bm = u[..., H * P:H * P + N].reshape(B, S, 1, N)
    Cm = u[..., H * P + N:].reshape(B, S, 1, N)
    return x, dt, A, Bm, Cm


def _ssd_needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the SSD kernel runs only there)")


def test_ssd_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: there is no fallback."""
    x = torch.ones((1, 16, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_module.ssd_chunk(x, x[..., 0], x[:, :, 0], x[:, :, 0], 16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_matches_plain_version_on_card(shape):
    _ssd_needs_card()
    gen = torch.Generator(device="cuda").manual_seed(shape[1] + shape[2])
    x, dt, A, Bm, Cm = _ssd_inputs(shape, gen)
    chunk = min(shape[-1], shape[1])
    a, xdt = dt * A, x * dt[..., None]
    before = ssd_module.launches["ssd_chunk_kernel"]
    got = ssd_module.ssd_chunk(xdt, a, Bm[:, :, 0], Cm[:, :, 0], chunk)
    assert ssd_module.launches["ssd_chunk_kernel"] == before + 1
    want = ref.ssd_chunks(xdt, a, Bm[:, :, 0], Cm[:, :, 0], chunk)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **SSD_TOL)


@pytest.mark.cuda
def test_ssd_kernel_takes_any_strides_on_card():
    """x with a last stride other than 1 and x starting off a 16-byte
    boundary (the wrapper copies it for the kernel's 16-byte loads), a, B
    and C as strided views: the same numbers as the plain version."""
    _ssd_needs_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, dt, A, Bm, Cm = _ssd_inputs((1, 256, 4, 32, 64, 128), gen)
    a, b, c = (dt * A).transpose(0, 1).contiguous().transpose(0, 1), \
        Bm[:, :, 0], Cm[:, :, 0]
    xdt = x * dt[..., None]
    for view in (xdt.transpose(2, 3).contiguous().transpose(2, 3),
                 torch.cat([xdt.new_zeros(1), xdt.flatten()])[1:].view(
                     xdt.shape)):
        assert view.stride(-1) != 1 or view.data_ptr() % 16
        got = ssd_module.ssd_chunk(view, a, b, c, 128)
        want = ref.ssd_chunks(xdt, a, b, c, 128)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **SSD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_matches_ssd_chunked_on_card(shape):
    """ops.ssd_scan (the kernel plus the host's recurrence) against the
    model's own ssd_chunked on the same card, from a nonzero state."""
    _ssd_needs_card()
    gen = torch.Generator(device="cuda").manual_seed(shape[1] * 3)
    x, dt, A, Bm, Cm = _ssd_inputs(shape, gen)
    B, _, H, P, N, chunk = shape
    state = torch.randn((B, H, P, N), generator=gen, device="cuda") * 0.1
    before = ssd_module.launches["ssd_chunk_kernel"]
    got = ops.ssd_scan(x, dt, A, Bm, Cm, chunk, initial_state=state)
    assert ssd_module.launches["ssd_chunk_kernel"] == before + 1
    want = mamba.ssd_chunked(x, dt, A, Bm, Cm, chunk, initial_state=state)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SSD_TOL)


@pytest.mark.cuda
def test_ssd_kernel_refusals_on_card():
    """No silent fallback on the card: grad-requiring inputs (through
    ops.ssd_scan and mamba_apply) go through the backward kernel, and
    grouped B/C and anything the kernel does not take raise."""
    _ssd_needs_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, dt, A, Bm, Cm = _ssd_inputs((1, 64, 2, 64, 16, 32), gen)
    before = ssd_module.launches["ssd_chunk_bwd_kernel"]
    y, _ = ops.ssd_scan(x.requires_grad_(True), dt, A, Bm, Cm, 32)
    y.sum().backward()
    assert ssd_module.launches["ssd_chunk_bwd_kernel"] == before + 1
    assert x.grad is not None and torch.isfinite(x.grad).all()
    with torch.no_grad():
        ops.ssd_scan(x, dt, A, Bm, Cm, 32)
    x = x.detach()
    with pytest.raises(NotImplementedError, match="n_groups"):
        ops.ssd_scan(x, dt, A, torch.cat([Bm, Bm], 2),
                     torch.cat([Cm, Cm], 2), 32)
    a, xdt, b, c = dt * A, x * dt[..., None], Bm[:, :, 0], Cm[:, :, 0]
    with pytest.raises(TypeError, match="float32"):
        ssd_module.ssd_chunk(xdt.bfloat16(), a, b, c, 32)
    with pytest.raises(ValueError, match="head dim"):
        ssd_module.ssd_chunk(xdt[..., :48], a, b, c, 32)
    with pytest.raises(ValueError, match="d_state"):
        ssd_module.ssd_chunk(xdt, a, b[..., :8], c[..., :8], 32)
    with pytest.raises(ValueError, match="chunk"):
        ssd_module.ssd_chunk(xdt, a, b, c, 48)

    cfg = mamba.SSMConfig(d_state=16, chunk_size=32)
    params = mamba.init_mamba(gen, 64, cfg)
    h = torch.randn((1, 64, 64), generator=gen, device="cuda")
    params["in_proj"].requires_grad_(True)
    grads = []
    for use_kernel in (True, False):
        out, _, _ = mamba.mamba_apply(params, h, cfg, 64,
                                      use_kernel=use_kernel)
        grads.append(torch.autograd.grad(out.sum(), params["in_proj"]))
    _close_to_plain(*grads, rel=SSD_TOL["rtol"])


# the backward kernel: held to ref.ssd_chunks_bwd at 1e-4 of the largest
# plain gradient (3xTF32 against PyTorch's f32 products, summed in other
# orders); (B, S, H, P, N, chunk) as SSD_SHAPES, with mamba2-1.3b's
# training shapes (8 x 256 tokens, server and tower heads) first, then a
# last head group partly filled (201 heads, one chunk: HG 2 on 132 SMs)
# at P 32, N 16 and S = Q, and P 32 at N 128
SSD_BWD_SHAPES = [(8, 256, 64, 64, 128, 128), (8, 256, 16, 64, 128, 128),
                  (1, 128, 201, 32, 16, 128), (2, 256, 24, 32, 128, 128)] \
    + SSD_SHAPES
SSD_BWD_UPSTREAMS = {"all": (True, True, True), "gy": (True, False, False),
                     "gstate": (False, True, False),
                     "gcum": (False, False, True)}


def _ssd_bwd_inputs(shape, gen, upstream="all"):
    x, dt, A, Bm, Cm = _ssd_inputs(shape, gen)
    B, S, H, P, N, chunk = shape
    Q = min(chunk, S)
    ups = (torch.randn((B, S, H, P), generator=gen, device="cuda"),
           torch.randn((B, S // Q, H, P, N), generator=gen, device="cuda"),
           torch.randn((B, S, H), generator=gen, device="cuda"))
    ups = [u if on else None
           for u, on in zip(ups, SSD_BWD_UPSTREAMS[upstream])]
    return (x * dt[..., None], dt * A, Bm[:, :, 0], Cm[:, :, 0], *ups, Q)


def _close_to_plain(got, want, rel=1e-4):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        err = float((g - w).abs().max())
        assert err <= rel * max(float(w.abs().max()), 1e-30), (err, rel)


def test_ssd_bwd_wrapper_refuses_cpu_tensors():
    """The backward wrapper takes CUDA tensors only: there is no
    fallback."""
    x = torch.ones((1, 16, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_module.ssd_chunk_bwd(x, x[..., 0], x[:, :, 0], x[:, :, 0], x,
                                 None, None, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("upstream", list(SSD_BWD_UPSTREAMS))
@pytest.mark.parametrize("shape", SSD_BWD_SHAPES)
def test_ssd_bwd_kernel_matches_plain_version_on_card(shape, upstream):
    _ssd_needs_card()
    gen = torch.Generator(device="cuda").manual_seed(shape[1] + shape[2])
    args = _ssd_bwd_inputs(shape, gen, upstream)
    before = ssd_module.launches["ssd_chunk_bwd_kernel"]
    got = ssd_module.ssd_chunk_bwd(*args)
    assert ssd_module.launches["ssd_chunk_bwd_kernel"] == before + 1
    want = ref.ssd_chunks_bwd(*args)
    torch.cuda.synchronize()
    _close_to_plain(got, want)


def _expected_bwd_heads(B, S, H, N, chunk, sms):
    """The backward's heads per block by its launcher's rule: fewest waves
    of blocks over the SMs times (HG + 1)."""
    slices = -(-N // 128)
    per_group = (S // chunk) * B * slices
    return min(range(1, H + 1), key=lambda hg: (
        -(-per_group * -(-H // hg) // sms) * (hg + 1), hg))


@pytest.mark.cuda
def test_ssd_bwd_plan_on_card():
    """The backward's plan at phase 12's server and tower shapes (8 x 256
    tokens): HG 8 and HG 2, 128 blocks each on an H100's 132 SMs, and by
    the launcher's rule on any other count; 201 heads in one chunk leave
    the last group partly filled."""
    _ssd_needs_card()
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for H, hg in ((64, 8), (16, 2)):
        plan = ssd_module.bwd_plan(8, 256, H, 64, 128, 128, device)
        want = hg if sms == 132 else _expected_bwd_heads(8, 256, H, 128, 128,
                                                          sms)
        assert plan["heads"] == want
        assert plan["groups"] == -(-H // want) and plan["slices"] == 1
        assert plan["blocks"] == 2 * 8 * plan["groups"]
    plan = ssd_module.bwd_plan(1, 128, 201, 32, 16, 128, device)
    if sms == 132:
        assert plan["heads"] == 2 and plan["groups"] == 101
    assert plan["heads"] == _expected_bwd_heads(1, 128, 201, 16, 128, sms)


@pytest.mark.cuda
def test_ssd_bwd_kernel_runs_on_tensor_cores():
    """Every instantiation of the backward kernel has HGMMA (wgmma)
    instructions in its SASS, read with the toolkit's cuobjdump."""
    import re
    import shutil
    import subprocess
    from pathlib import Path

    _ssd_needs_card()
    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        pytest.skip("no cuobjdump in the CUDA toolkit")
    sass = subprocess.run([tool, "-sass", str(build.build())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[-1].strip()
            current = name if "ssd_chunk_bwd_kernel" in name else None
            if current:
                counts[current] = 0
        elif current and re.search(r"\bHGMMA\b", line):
            counts[current] += 1
    assert len(counts) == 12 and all(counts.values()), counts


@pytest.mark.cuda
def test_ssd_bwd_kernel_is_deterministic_and_finite_on_card():
    """Two launches give the same bits (the heads' dB and dC terms and the
    groups' partials are summed in order, no float atomics); a = -80 per step (exp above the diagonal
    would overflow) stays finite and matches the plain version."""
    _ssd_needs_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = _ssd_bwd_inputs((2, 256, 64, 64, 128, 128), gen)
    first = ssd_module.ssd_chunk_bwd(*args)
    second = ssd_module.ssd_chunk_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    args = list(args)
    args[1] = torch.full_like(args[1], -80.0)
    _close_to_plain(ssd_module.ssd_chunk_bwd(*args),
                    ref.ssd_chunks_bwd(*args))


@pytest.mark.cuda
def test_ssd_bwd_wrapper_refusals_on_card():
    """The backward kernel's wrapper raises on what the kernel does not
    take, upstream gradients of the wrong shape or dtype included."""
    _ssd_needs_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    xdt, a, b, c, gy, gs, gc, Q = _ssd_bwd_inputs((1, 64, 2, 64, 16, 32),
                                                  gen)
    with pytest.raises(ValueError, match="gy must be"):
        ssd_module.ssd_chunk_bwd(xdt, a, b, c, gy[:, :32], gs, gc, Q)
    with pytest.raises(ValueError, match="gstate must be"):
        ssd_module.ssd_chunk_bwd(xdt, a, b, c, gy, gs[:, :1], gc, Q)
    with pytest.raises(TypeError, match="float32"):
        ssd_module.ssd_chunk_bwd(xdt, a, b, c, gy, gs, gc.double(), Q)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_module.ssd_chunk_bwd(xdt, a, b, c, gy.cpu(), gs, gc, Q)
    with pytest.raises(ValueError, match="head dim"):
        ssd_module.ssd_chunk_bwd(xdt[..., :48], a, b, c, None, None, gc, Q)
    with pytest.raises(ValueError, match="d_state"):
        ssd_module.ssd_chunk_bwd(xdt, a, b[..., :8], c[..., :8], gy, None,
                                 None, Q)
    with pytest.raises(ValueError, match="chunk"):
        ssd_module.ssd_chunk_bwd(xdt, a, b, c, gy, None, None, 48)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_grads_match_ssd_chunked_on_card(shape):
    """ops.ssd_scan under autograd on the card (both chunk kernels, the
    host's recurrence through autograd) against autograd of the model's
    own ssd_chunked, from a nonzero state: every input's gradient within
    3e-4 of its largest entry (the forward kernel's tolerance: the
    recurrence's gradients read its 3xTF32 states)."""
    _ssd_needs_card()
    gen = torch.Generator(device="cuda").manual_seed(shape[1] * 5)
    B, _, H, P, N, chunk = shape
    inputs = list(_ssd_inputs(shape, gen))
    inputs.append(torch.randn((B, H, P, N), generator=gen,
                              device="cuda") * 0.1)
    gy = torch.randn_like(inputs[0])
    gfin = torch.randn_like(inputs[-1])
    runs = []
    for fn in (ops.ssd_scan, mamba.ssd_chunked):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        before = ssd_module.launches["ssd_chunk_bwd_kernel"]
        y, fin = fn(*leaves[:5], chunk, initial_state=leaves[5])
        runs.append(torch.autograd.grad(
            (y * gy).sum() + (fin * gfin).sum(), leaves))
        launched = ssd_module.launches["ssd_chunk_bwd_kernel"] - before
        assert launched == (1 if fn is ops.ssd_scan else 0)
    _close_to_plain(*runs, rel=SSD_TOL["rtol"])
