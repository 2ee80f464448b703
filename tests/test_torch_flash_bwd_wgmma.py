"""A numpy model of the flash backward's tensor-core arithmetic
(``kernels/csrc/flash_attention_bwd.cu``), held on the CPU to ``jax.vjp``
of the JAX package's chunked attention, as ``tests/test_torch_flash.py``
models the forward and ``tests/test_torch_ssd_bwd_model.py`` the SSD
backward.

The kernels run only on a card.  The model follows them in f32: the
tiling of each head dim (read from ``Plan`` in the source: two warpgroups
and 32-row tiles up to D = 64, one warpgroup above, 16-row tiles at D =
112 and 128); Delta; dkdv per (batch, q head, kv block), each
warpgroup's 64 kv rows over the q tiles at or below the diagonal, S^T =
K Q^T and dP^T = V dO^T, P^T and dS^T per element with every mask, then
dV += P^T dO and dK += dS^T Q (each tile's product in a fresh
accumulator, added to the running sums in f32); each q head's partials
summed over the group in head order; dq per (batch, q head, q block) over
the kv tiles up to the diagonal, each tile's dS K likewise added.  Every
product is issued as the kernel issues it: 8-deep k-steps, in f32 each
accumulated as a_lo b_hi + a_hi b_lo + a_hi b_hi (3xTF32); in bf16 the
inputs are exact in TF32, so S and dP take one pass and the products with
P and dS (split) two.  (With exact f32 products the same model holds the
schedule alone: ``tests/test_torch_flash_bwd_model.py``.)  Then the
operand layouts: the split passes' thread mappings, the descriptors, and
the accumulator reused as A with its columns renamed, exact in float64
through ``tests/wgmma_model.py``.  Last, guards on the source: no
atomics, and the kernel names of the wrapper and of ``chip_profile.py``.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ref
from test_torch_flash_bwd import _inputs, _jax_chunked, _jax_vjp
from wgmma_model import (CORE, _core_index, _fragments, _from_wgmma, _lanes,
                         _split, _tf32, _wgmma, _wgmma_b)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / \
    "flash_attention_bwd.cu"
LOG2E = np.float32(1.4426950408889634)
WG_ROWS = 64  # rows per warpgroup: wgmma's M
# chip_smoke.py phase 19 (a): f32 gradients within this share of their
# largest plain entry, at this many tokens
CARD_F32_GATE = 1e-4
CARD_S = 2304


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs in parallel worker processes: one intra-op thread
    keeps torch from oversubscribing the cores the other workers use."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _plan(d):
    """(warpgroups per block, tile rows) of head dim ``d``, read from the
    source's ``Plan<T, D>``: ``WGS`` and ``TILE``, each ``D <= limit ? a :
    b``."""
    text = SOURCE.read_text()
    out = []
    for name in ("WGS", "TILE"):
        found = re.search(rf"static constexpr int {name} = D <= (\d+) \? "
                          rf"(\d+) : (\d+);", text)
        assert found, f"Plan<T, D>::{name} not found in {SOURCE.name}"
        limit, small, large = map(int, found.groups())
        out.append(small if d <= limit else large)
    return tuple(out)


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------

def _accumulate(acc, a, b, passes):
    """acc += a (M, K) @ b (K, N) as the kernel issues it: 8-deep k-steps,
    each pass accumulated in f32 (``passes`` 3: a_lo b_hi, a_hi b_lo,
    a_hi b_hi; 2: a_lo b_hi, a_hi b_hi with b exact; 1: a_hi b_hi); or,
    with ``passes`` 0, the exact f32 product in one matmul."""
    if passes == 0:
        acc += (a @ b).astype(np.float32)
        return acc
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    terms = {3: [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)],
             2: [(a_lo, b_hi), (a_hi, b_hi)], 1: [(a_hi, b_hi)]}[passes]
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            acc += (x[:, k0:k0 + 8] @ y[k0:k0 + 8]).astype(np.float32)
    return acc


def _kernel_model(q, k, v, o, lse, do, causal, route):
    """The four kernels' work in their order, f32 numpy.  ``route``:
    "f32" (3xTF32 everywhere), "bf16" (inputs exact in TF32: S and dP one
    pass, the products with P and dS two), "one_pass" (a single TF32 pass
    everywhere, what the split is there to avoid) or "exact" (exact f32
    products: the tile schedule alone).  Tiles wholly above a
    warpgroup's rows are never visited, and each kernel visits every
    attended pair once."""
    f32 = np.float32
    B, H, S, D = q.shape
    group = H // k.shape[1]
    wgs, tile = _plan(D)
    rows = wgs * WG_ROWS
    n_in = {"f32": 3, "bf16": 1, "one_pass": 1, "exact": 0}[route]  # S, dP
    n_p = {"f32": 3, "bf16": 2, "one_pass": 1, "exact": 0}[route]  # P, dS
    scale = f32(1.0 / np.sqrt(f32(D)))
    sl2 = f32(LOG2E * scale)
    delta = np.sum(do * o, axis=-1, dtype=f32)
    lse2 = (lse * LOG2E).astype(f32)

    def pad(x, n):
        out = np.zeros((n, D), f32)
        out[:min(n, len(x))] = x[:n]
        return out

    def rows_of(x, r0, n):  # rows r0 .. r0 + n, zeros past S
        return pad(x[r0:r0 + n], n)

    part = np.zeros((2, B, H, S, D), f32)
    dq = np.zeros_like(q)
    pairs_kv = pairs_q = 0
    for b in range(B):
        for h in range(H):
            hk = h // group
            # dkdv: kv blocks, each warpgroup 64 kv rows
            for kv0 in range(0, S, rows):
                for w in range(wgs):
                    kw0 = kv0 + w * WG_ROWS
                    kt = rows_of(k[b, hk], kw0, WG_ROWS)
                    vt = rows_of(v[b, hk], kw0, WG_ROWS)
                    acc_k = np.zeros((WG_ROWS, D), f32)
                    acc_v = np.zeros((WG_ROWS, D), f32)
                    first = kv0 // tile if causal else 0
                    for q0 in range(first * tile, S, tile):
                        if causal and q0 + tile - 1 < kw0:
                            continue
                        qt = rows_of(q[b, h], q0, tile)
                        dot = rows_of(do[b, h], q0, tile)
                        cols = np.arange(q0, q0 + tile)
                        ok = cols < S
                        l2 = np.where(ok, lse2[b, h, np.minimum(cols, S - 1)],
                                      0).astype(f32)
                        dl = np.where(ok, delta[b, h, np.minimum(cols, S - 1)],
                                      0).astype(f32)
                        st = _accumulate(np.zeros((WG_ROWS, tile), f32), kt,
                                         qt.T, n_in)
                        dpt = _accumulate(np.zeros((WG_ROWS, tile), f32), vt,
                                          dot.T, n_in)
                        pt = np.exp2(st * sl2 - l2[None, :]).astype(f32)
                        r = np.arange(kw0, kw0 + WG_ROWS)[:, None]
                        att = (r < S) & ok[None, :]
                        if causal:
                            att &= r <= cols[None, :]
                        pt = np.where(att, pt, f32(0))
                        pairs_kv += int(att.sum())
                        dst = (pt * (dpt - dl[None, :])).astype(f32)
                        acc_v += _accumulate(np.zeros_like(acc_v), pt, dot,
                                             n_p)
                        acc_k += _accumulate(np.zeros_like(acc_k), dst, qt,
                                             n_p)
                    n = max(0, min(WG_ROWS, S - kw0))
                    part[0, b, h, kw0:kw0 + n] = acc_k[:n]
                    part[1, b, h, kw0:kw0 + n] = acc_v[:n]
            # dq: q blocks, each warpgroup 64 q rows
            for qb0 in range(0, S, rows):
                last_row = min(S, qb0 + rows) - 1
                n_kv = last_row // tile + 1 if causal else -(-S // tile)
                for w in range(wgs):
                    wq0 = qb0 + w * WG_ROWS
                    qt = rows_of(q[b, h], wq0, WG_ROWS)
                    dot = rows_of(do[b, h], wq0, WG_ROWS)
                    r = np.arange(wq0, wq0 + WG_ROWS)
                    ok = r < S
                    l2 = np.where(ok, lse2[b, h, np.minimum(r, S - 1)], 0)
                    dl = np.where(ok, delta[b, h, np.minimum(r, S - 1)], 0)
                    acc = np.zeros((WG_ROWS, D), f32)
                    for kv0 in range(0, n_kv * tile, tile):
                        if causal and kv0 > wq0 + WG_ROWS - 1:
                            continue
                        kt = rows_of(k[b, hk], kv0, tile)
                        vt = rows_of(v[b, hk], kv0, tile)
                        s = _accumulate(np.zeros((WG_ROWS, tile), f32), qt,
                                        kt.T, n_in)
                        dp = _accumulate(np.zeros((WG_ROWS, tile), f32), dot,
                                         vt.T, n_in)
                        p = np.exp2(s * sl2 - l2[:, None].astype(f32))
                        cols = np.arange(kv0, kv0 + tile)[None, :]
                        att = ok[:, None] & (cols < S)
                        if causal:
                            att &= cols <= r[:, None]
                        p = np.where(att, p, f32(0)).astype(f32)
                        pairs_q += int(att.sum())
                        ds = (p * (dp - dl[:, None].astype(f32))).astype(f32)
                        acc += _accumulate(np.zeros_like(acc), ds, kt, n_p)
                    n = max(0, min(WG_ROWS, S - wq0))
                    dq[b, h, wq0:wq0 + n] = acc[:n] * scale
    per_head = S * (S + 1) // 2 if causal else S * S
    assert pairs_kv == pairs_q == B * H * per_head
    # the reduce pass: each kv head's group summed in head order, dK scaled
    Hkv = H // group
    grouped = part.reshape(2, B, Hkv, group, S, D)
    dk = np.zeros((B, Hkv, S, D), f32)
    dv = np.zeros_like(dk)
    for g in range(group):
        dk += grouped[0, :, :, g]
        dv += grouped[1, :, :, g]
    return dq, dk * scale, dv


def _forward(q, k, v, causal, dtype=torch.float32):
    """The forward's output and logsumexp (the plain twin of what the
    forward kernel hands the backward), in ``dtype``, as f32 numpy."""
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    o, lse = ref.flash_attention_lse(*t, causal=causal)
    return o.float().numpy(), lse.numpy()


def _rel(got, want):
    """Each gradient's largest |model - reference| over its largest
    reference entry."""
    return [float(np.abs(g - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


# (B, H, Hkv, S, D): GQA groups of 3 and 2 with a ragged last tile and a
# ragged last block at each head dim's tiling
MODEL_SHAPES = [(1, 3, 1, 150, 32), (1, 4, 2, 150, 64), (1, 3, 1, 75, 128)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_3xtf32_model_matches_jax_vjp(shape, causal):
    """The kernels' 3xTF32 arithmetic in their tile order, with the
    group's partials summed in head order, is held to ``jax.vjp`` of the
    reference's chunked attention within 1e-4 of each gradient's largest
    entry, the f32 gate of the card; one TF32 pass everywhere errs at
    least 10x more, and past that gate."""
    B, H, Hkv, S, D = shape
    q, k, v, do = _inputs(S * D + H, *shape)
    o, lse = _forward(q, k, v, causal)
    want = _jax_vjp(_jax_chunked(causal, S), (q, k, v, do), "float32")
    err3 = _rel(_kernel_model(q, k, v, o, lse, do, causal, "f32"), want)
    err1 = _rel(_kernel_model(q, k, v, o, lse, do, causal, "one_pass"), want)
    assert max(err3) <= 1e-4, err3
    assert max(err1) >= 10 * max(err3), (err1, err3)
    assert max(err1) > CARD_F32_GATE, err1


def test_one_pass_fails_the_card_gate():
    """A kernel that dropped the lo passes (one TF32 pass per product)
    fails the card's f32 gate at the card's own length: at CARD_S tokens
    (D 64, a group of 2) every gradient of the one-pass model errs past
    CARD_F32_GATE of its largest entry against ``jax.vjp``."""
    shape = (1, 2, 1, CARD_S, 64)
    q, k, v, do = _inputs(CARD_S, *shape)
    o, lse = _forward(q, k, v, True)
    want = _jax_vjp(_jax_chunked(True, CARD_S), (q, k, v, do), "float32")
    err1 = _rel(_kernel_model(q, k, v, o, lse, do, True, "one_pass"), want)
    assert min(err1) > CARD_F32_GATE, err1


@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_bf16_route_model_matches_jax_vjp(shape):
    """In bf16, Q, K, V and dO are exact in TF32: S and dP take one pass,
    the products with the f32 P and dS (split) two, the gradients are
    rounded to bf16 once.  Held to ``jax.vjp`` of the chunked attention
    at the bf16-rounded inputs within 2e-2 of each gradient's largest
    entry, the bf16 gate of the card; the inputs are exact in TF32."""
    B, H, Hkv, S, D = shape
    arrays = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
              for a in _inputs(S + D, *shape)]
    q, k, v, do = arrays
    for a in arrays:
        np.testing.assert_array_equal(_tf32(a), a)
    o, lse = _forward(q, k, v, True, torch.bfloat16)
    want = _jax_vjp(_jax_chunked(True, S), arrays, "float32")
    got = [torch.from_numpy(g).to(torch.bfloat16).float().numpy() for g in
           _kernel_model(q, k, v, o, lse, do, True, "bf16")]
    assert max(_rel(got, want)) <= 2e-2


# ---------------------------------------------------------------------------
# the operand layouts and fragments, exact in float64
# ---------------------------------------------------------------------------

def _split_rows(x, rows, d):
    """``split_tile``'s rows (and ``load_rows``): thread idx writes core
    matrix idx // 8, row idx % 8 (row 8 nb + r, d 4 kb .. 4 kb + 3) at
    word 4 idx."""
    tile = np.full(rows * d, np.nan)
    for idx in range(rows * d // 4):
        kb = (idx // 8) % (d // 4)
        r = 8 * ((idx // 8) // (d // 4)) + idx % 8
        tile[4 * idx:4 * idx + 4] = x[r, 4 * kb:4 * kb + 4]
    return tile


def _split_cols(x, rows, d):
    """``split_tile``'s transposed tiles: thread idx takes d = idx % D and
    K positions 4 kb .. 4 kb + 3, the rows 8 (kb // 2) + kb % 2 + 2e,
    written at core_index(d, 4 kb, rows)."""
    tile = np.full(rows * d, np.nan)
    for idx in range(rows * d // 4):
        dd, kb = idx % d, idx // d
        at = _core_index(dd, 4 * kb, rows)
        tile[at:at + 4] = x[8 * (kb // 2) + kb % 2 + 2 * np.arange(4), dd]
    return tile


def _product_ss(a_tile, b_tile, d, n):
    """A (this warpgroup's 64 rows) and B (n rows) from shared memory,
    both K-major along d: the k-steps of ``product_ss`` through the
    descriptors (word kk * 2 * CORE, SBO (d / 4) * 128 bytes)."""
    acc = np.zeros((4, 32, n // 2))
    for kk in range(d // 8):
        a = _wgmma_b(a_tile, kk * 2 * CORE, (d // 4) * 128, 64).T
        acc = _wgmma(_fragments(a), _wgmma_b(b_tile, kk * 2 * CORE,
                                             (d // 4) * 128, n), acc)
    return acc


def _product_rs(acc, frag_src, b_tile, n_k, d):
    """``product_rs`` with A from the accumulator ``frag_src`` renamed as
    ``fragments`` does (c0, c2, c1, c3 of each 8 columns) and B read
    through descriptors at word j * 2 * CORE, SBO (n_k / 4) * 128 bytes."""
    for j in range(n_k // 8):
        a = frag_src[:, :, [4 * j, 4 * j + 2, 4 * j + 1, 4 * j + 3]]
        acc = _wgmma(a, _wgmma_b(b_tile, j * 2 * CORE, (n_k // 4) * 128, d),
                     acc)
    return acc


@pytest.mark.parametrize("d", [32, 64, 80, 112, 128])
def test_dkdv_operand_layout_and_renamed_fragments(d):
    """dkdv's tiles through the kernel's own indexing at each head dim's
    q tile: K (A, from load_rows) times Q (B, split_tile's rows) gives
    S^T = K Q^T; the S^T accumulator reused as A with its q columns
    renamed, times Q^T (B, split_tile's transposed tile) gives S^T Q;
    likewise dP^T = V dO^T and dP^T dO.  Then P^T dO and dS^T Q hold for
    any elementwise P^T, dS^T the kernel computes in the accumulator."""
    _, qt = _plan(d)
    rng = np.random.default_rng(d)
    K, V = rng.standard_normal((2, 64, d))
    Q, dO = rng.standard_normal((2, qt, d))
    for a, bq in ((K, Q), (V, dO)):
        a_tile, b_tile = _split_rows(a, 64, d), _split_rows(bq, qt, d)
        cols = _split_cols(bq, qt, d)
        assert not np.isnan(a_tile).any() and not np.isnan(cols).any()
        for r in range(qt):
            for c in range(d):
                assert b_tile[_core_index(r, c, d)] == bq[r, c]
        st = _product_ss(a_tile, b_tile, d, qt)
        np.testing.assert_allclose(_from_wgmma(st), a @ bq.T, rtol=1e-12,
                                   atol=1e-12)
        pt = np.tanh(st)  # an elementwise P^T in the accumulator's slots
        acc = _product_rs(np.zeros((4, 32, d // 2)), pt, cols, qt, d)
        np.testing.assert_allclose(_from_wgmma(acc),
                                   np.tanh(a @ bq.T) @ bq, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("d", [32, 64, 80, 112, 128])
def test_dq_operand_layout_and_renamed_fragments(d):
    """dq's tiles at each head dim's kv tile: Q (A, from load_rows) times
    K (B, split_tile's rows) gives S = Q K^T, and the fragments each lane
    reads back from Q's tile are Q's A fragments; dS in the accumulator
    reused as A with its kv columns renamed, times K^T (B, split_tile's
    transposed tile), gives dS K."""
    _, kt = _plan(d)
    rng = np.random.default_rng(d + 1)
    Q = rng.standard_normal((64, d))
    K = rng.standard_normal((kt, d))
    q_tile = _split_rows(Q, 64, d)
    s = _product_ss(q_tile, _split_rows(K, kt, d), d, kt)
    np.testing.assert_allclose(_from_wgmma(s), Q @ K.T, rtol=1e-12,
                               atol=1e-12)
    # up to D = 64 Q's hi is also read into registers (read_fragments):
    # lane 4g + t of warp w takes rows 16w + g (+ 8), columns 8 kk + t
    # (+ 4) of the tile, which are Q's A fragments of each k-step
    g, t = _lanes()
    for kk in range(d // 8):
        read = np.stack([np.stack([
            q_tile[_core_index(16 * w + g + 8 * (i & 1),
                               8 * kk + t + 4 * (i >> 1), d)]
            for i in range(4)], axis=1) for w in range(4)])
        np.testing.assert_array_equal(read,
                                      _fragments(Q[:, 8 * kk:8 * kk + 8]))
    ds = np.sin(s)
    acc = _product_rs(np.zeros((4, 32, d // 2)), ds, _split_cols(K, kt, d),
                      kt, d)
    np.testing.assert_allclose(_from_wgmma(acc), np.sin(Q @ K.T) @ K,
                               rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# guards on the source
# ---------------------------------------------------------------------------

def test_source_has_no_atomics_and_names_match():
    """Determinism: no atomic in the source's code.  ``BWD_KERNELS``
    names every ``__global__`` of the file, in launch order, and
    ``chip_profile.py`` lists the same flash backward kernels."""
    text = SOURCE.read_text()
    code = re.sub(r"//[^\n]*", "", text)
    assert "atomic" not in code.lower()
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*"
                         r"\)\s+)?(\w+)\(", text)
    assert sorted(kernels) == sorted(flash_kernel.BWD_KERNELS)
    launched = re.findall(r"(flash_attention_bwd_\w+_kernel)(?:<[^>]*>)?\s*"
                          r"<<<", text)
    assert tuple(launched) == flash_kernel.BWD_KERNELS
    profile = (ROOT / "chip_profile.py").read_text()
    listed = set(re.findall(r'"(flash_attention_bwd_\w+)"', profile))
    assert listed == set(flash_kernel.BWD_KERNELS)
