"""A numpy model of the CUDA SSD backward kernel
(``src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu``): its 3xTF32 arithmetic
and its operand layouts, on the CPU.

The kernel runs only on a card.  Its arithmetic is modelled as it issues
it: every product 3xTF32 in 8-deep k-steps (``tests/wgmma_model.py``), C
B^T once per group of HG heads (held transposed, G^T = B C^T), dx = M^T gy
+ (w o B) gS^T in one accumulator and T through it (sum_p x dx less the
column sums of R), the sums over the group's heads D^T = sum_h dM_h^T o
L_h^T and (in a second pass over them) E = sum_h (x_h o w_h) gS_h
accumulated in head order, each group's partials dB_g = E + D^T C and
dC_g = (B^T D)^T, and the groups' partials summed in order.  The model is
held to ``jax.vjp`` of the JAX package's ``ref.ssd_chunk`` at 1e-4 of each
gradient's largest entry (the card's gate, ``chip_smoke.py`` phase 7), and
a single TF32 pass is shown to err at least 10x more.  The layouts of the
operands that the kernel reads transposed or renamed (M^T and D^T as A
fragments in the accumulator's layout, gy^T and C^T with the chunk's rows
along K, B^T as A with the chunk's rows along K against the D tile, and
phase A's x fragments against the gy tile) are checked exactly in float64
through ``_core_index``, ``_fragments`` and ``_wgmma_b``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jax_ref
from wgmma_model import (CORE, _core_index, _fragments, _from_wgmma, _lanes,
                         _split, _wgmma, _wgmma_b)

H, HG = 6, 4  # two groups, the last partly filled
ROWS = 128    # chunk rows a block's tiles hold (two warpgroups of 64)
SBO_ROWS = (ROWS // 4) * 128  # tiles with the chunk's rows along K
REL = 1e-4
# (Q, P, N): the chunk lengths (the reduced config's 32, a prompt shorter
# than a chunk, the model's 128), head dims and d_state classes it takes
MODEL_CASES = [(q, p, n) for q in (32, 96, 128) for p in (16, 32, 64)
               for n in (16, 128)]


def _accumulate(c, a, b, passes):
    """c + a (M, K) @ b (K, N) as wgmma accumulates it: 8-deep k-steps,
    each a_lo b_hi + a_hi b_lo + a_hi b_hi added in f32 (``passes=1``: a_hi
    b_hi only)."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    terms = ([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if passes == 3
             else [(a_hi, b_hi)])
    c = np.asarray(c, np.float32).copy()
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            c += x[:, k0:k0 + 8] @ y[k0:k0 + 8]
    return c


def _scan(a):
    """cum as warp 0 takes it (four values a lane, the lanes' totals by
    shuffles up) and cum_Q; f32."""
    v = np.zeros(ROWS, np.float32)
    v[:len(a)] = a
    v = np.cumsum(v.reshape(32, 4), axis=1, dtype=np.float32)
    run = v[:, 3].copy()
    lane = np.arange(32)
    for d in (1, 2, 4, 8, 16):
        run = np.where(lane >= d, run + np.roll(run, d), run).astype(
            np.float32)
    cum = (v + (run - v[:, 3])[:, None]).reshape(-1)
    return cum[:len(a)], run[31]


def _kernel_bwd(x, a, Bm, Cm, gy, gS, gcum, passes=3):
    """One chunk of H heads (shared B and C) as the kernel computes it.
    x, gy (H, Q, P), a, gcum (H, Q), Bm, Cm (Q, N), gS (H, P, N).  Returns
    dx (H, Q, P), da (H, Q), dB and dC (Q, N)."""
    Q, P = x.shape[1:]
    f32 = np.float32
    upper = np.triu(np.ones((Q, Q), bool))  # (j, i): i >= j
    dx = np.zeros_like(x)
    da = np.zeros_like(a)
    dB = np.zeros(Bm.shape, f32)
    dC = np.zeros(Bm.shape, f32)
    for g0 in range(0, H, HG):
        Gt = _accumulate(np.zeros((Q, Q)), Bm, Cm.T, passes)  # B C^T
        Dt = np.zeros((Q, Q), f32)
        heads = range(g0, min(H, g0 + HG))
        for h in heads:
            cum, last = _scan(a[h])
            w = np.exp(last - cum).astype(f32)
            Lt = np.exp(np.where(upper, cum[None, :] - cum[:, None],
                                 -np.inf)).astype(f32)
            dMt = _accumulate(np.zeros((Q, Q)), x[h], gy[h].T, passes)
            Dt += dMt * Lt
            Mt = Gt * Lt
            Rt = dMt * Mt
            colsum_r, rowsum_r = Rt.sum(1, dtype=f32), Rt.sum(0, dtype=f32)
            # dx = M^T gy + (w o B) gS^T in one accumulator; T_j = w_j
            # sum_p x_jp (B gS^T)_jp taken as sum_p x_jp dx_jp - colsum(R)_j
            dx[h] = _accumulate(_accumulate(np.zeros((Q, P)), Mt, gy[h],
                                            passes),
                                Bm * w[:, None], gS[h].T, passes)
            T = (x[h] * dx[h]).sum(1, dtype=f32) - colsum_r
            dcum = rowsum_r - colsum_r - T + gcum[h]
            dcum[-1] += T.sum(dtype=f32)
            da[h] = np.cumsum(dcum[::-1], dtype=f32)[::-1]
        E = np.zeros(Bm.shape, f32)  # the second pass over the heads
        for h in heads:
            cum, last = _scan(a[h])
            w = np.exp(last - cum).astype(f32)
            E = _accumulate(E, x[h] * w[:, None], gS[h], passes)
        dB += _accumulate(E, Dt, Cm, passes)                   # E + D^T C
        dC += _accumulate(np.zeros((Bm.shape[1], Q)), Bm.T, Dt,
                          passes).T                            # (B^T D)^T
    return dx, da, dB, dC


def _inputs(Q, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((H, Q, P)) * 0.7
    a = -np.exp(rng.standard_normal((H, 1)) * 0.3) * np.log1p(
        np.exp(rng.standard_normal((H, Q)) * 0.5))
    Bm, Cm = (rng.standard_normal((Q, N)) * 0.3 for _ in range(2))
    gy = rng.standard_normal((H, Q, P))
    gS = rng.standard_normal((H, P, N))
    gcum = rng.standard_normal((H, Q))
    return [np.asarray(v, np.float32) for v in (x, a, Bm, Cm, gy, gS, gcum)]


def _jax_vjp(x, a, Bm, Cm, gy, gS, gcum):
    """jax.vjp of the JAX package's ref.ssd_chunk over the heads (B and C
    broadcast to every head), dB and dC summed over the heads."""
    heads = lambda m: jnp.broadcast_to(jnp.asarray(m), (H,) + m.shape)  # noqa
    _, vjp = jax.vjp(jax.vmap(jax_ref.ssd_chunk), jnp.asarray(x),
                     jnp.asarray(a), heads(Bm), heads(Cm))
    dx, da, dB, dC = vjp((jnp.asarray(gy), jnp.asarray(gS),
                          jnp.zeros((H,), jnp.float32), jnp.asarray(gcum)))
    return [np.asarray(v) for v in (dx, da, dB.sum(0), dC.sum(0))]


@pytest.mark.parametrize("Q,P,N", MODEL_CASES)
def test_3xtf32_ssd_bwd_model_matches_jax_vjp(Q, P, N):
    """The kernel's grouped 3xTF32 arithmetic on six heads in groups of
    four against jax.vjp of the JAX package's ref.ssd_chunk: each gradient
    within 1e-4 of its largest entry; one TF32 pass errs at least 10x more
    on dx or dB."""
    args = _inputs(Q, P, N, seed=Q * P + N)
    want = _jax_vjp(*args)
    err = {}
    for passes in (3, 1):
        got = _kernel_bwd(*args, passes=passes)
        err[passes] = [float(np.abs(g - w).max() / np.abs(w).max())
                       for g, w in zip(got, want)]
    assert max(err[3]) <= REL, err[3]
    assert max(err[1][0], err[1][2]) >= 10 * max(err[3][0], err[3][2]), err


# ---------------------------------------------------------------------------
# the operand layouts, exact in float64
# ---------------------------------------------------------------------------

def _renamed(k):
    """The chunk row stored at K position k of a tile whose A operand comes
    renamed from an accumulator (gy^T, C^T): within each 8-step, positions
    t and t + 4 hold rows 2t and 2t + 1."""
    k = np.asarray(k)
    return 8 * (k // 8) + 2 * (k % 4) + (k % 8) // 4


def _rows_along_k(M, rows):
    """gy^T and C^T as the kernel stores them, from M (ROWS, rows): thread
    idx takes row r = idx % rows and K positions 4 kb .. 4 kb + 3 (chunk
    rows 8 (kb // 2) + kb % 2 + 2e), stored at core_index(r, 4 kb)."""
    tile = np.zeros(rows * ROWS)
    for idx in range(rows * ROWS // 4):
        r, kb = idx % rows, idx // rows
        at = _core_index(r, 4 * kb, ROWS)
        tile[at:at + 4] = M[8 * (kb >> 1) + (kb & 1) + 2 * np.arange(4), r]
    return tile


def _slices(M, kd):
    """A tile with K along M's columns (gy with K = p): thread idx takes
    core matrix idx // 8, its row idx % 8 (row i, columns 4 kb .. 4 kb +
    3) at word 4 idx."""
    tile = np.zeros(M.shape[0] * kd)
    for idx in range(M.shape[0] * kd // 4):
        kb = (idx >> 3) % (kd // 4)
        i = 8 * ((idx >> 3) // (kd // 4)) + (idx & 7)
        assert 4 * idx == _core_index(i, 4 * kb, kd)
        tile[4 * idx:4 * idx + 4] = M[i, 4 * kb:4 * kb + 4]
    return tile


def _elements(wg):
    """Rows and columns of each accumulator element of warpgroup wg's Q x Q
    terms (4 warps, 32 lanes, element 4 q + 2 r + e): row 64 wg + 16 w + g
    + 8 r, column 64 wg + 8 q + 2 t + e."""
    g, t = _lanes()
    i = np.arange(64 - 32 * wg)
    row = 64 * wg + 16 * np.arange(4)[:, None, None] + g[None, :, None] \
        + 8 * ((i >> 1) & 1)
    col = 64 * wg + 8 * (i >> 2) + 2 * t[None, :, None] + (i & 1)
    return row, np.broadcast_to(col, row.shape)


@pytest.mark.parametrize("Q,P,N", [(128, 64, 128), (96, 32, 16),
                                   (32, 16, 128)])
def test_ssd_bwd_operand_layouts(Q, P, N):
    """The kernel's indexing on one chunk, rows past Q zero-filled:
    phase A's x fragments against the gy tile, 64 rows i at a time
    (warpgroup 1 from row 64), give dM^T = x gy^T; M^T and D^T taken from the accumulator layout as A
    fragments (elements 4q, 4q + 2, 4q + 1, 4q + 3) against gy^T and C^T
    with the chunk's rows along K, renamed, give dx = M^T gy and D^T C;
    and B^T's fragments (the chunk's rows along K) against the D tile
    (rows i, K = j, stored from D^T's slots at core_index(i, j), zeros
    where warpgroup 1 holds no column) give B^T D."""
    rng = np.random.default_rng(Q + P + N)
    pad = ((0, ROWS - Q), (0, 0))
    x, gy = (np.pad(rng.standard_normal((Q, P)), pad) for _ in range(2))
    Bm, Cm = (np.pad(rng.standard_normal((Q, N)), pad) for _ in range(2))
    M = np.triu(rng.standard_normal((ROWS, ROWS)))  # a (j, i) upper form
    M[Q:] = 0
    M[:, Q:] = 0
    g, t = _lanes()
    gy_tile = _slices(gy, P)
    gyt_tile = _rows_along_k(gy, P)
    ct_tile = _rows_along_k(Cm, N)
    for k in range(ROWS):
        np.testing.assert_array_equal(
            gyt_tile[[_core_index(pp, k, ROWS) for pp in range(P)]],
            gy[_renamed(k)])
    d_tile = np.full(ROWS * ROWS, np.nan)
    for wg in (0, 1):
        nc = 128 - 64 * wg
        rows = slice(64 * wg, 64 * wg + 64)
        row, col = _elements(wg)
        # phase A: x's A fragments (rows row0, row0 + 8; p = 8 kk + t, + 4)
        # against the gy tile, 64 columns i at a time from C1
        for c1 in range(ROWS - nc, ROWS, 64):
            acc = np.zeros((4, 32, 32))
            for kk in range(P // 8):
                frag = _fragments(x[rows, 8 * kk:8 * kk + 8])
                acc = _wgmma(frag, _wgmma_b(gy_tile, c1 * P + kk * 2 * CORE,
                                            (P // 4) * 128, 64), acc)
            np.testing.assert_allclose(_from_wgmma(acc),
                                       x[rows] @ gy[c1:c1 + 64].T,
                                       atol=1e-12)
        # M^T (and D^T) from the accumulator layout, renamed
        held = M[row, col]
        dx = np.zeros((4, 32, P // 2))
        db = np.zeros((4, 32, N // 2))
        for q in range(nc // 8):
            kk = (ROWS - nc) // 8 + q
            frag = held[:, :, [4 * q, 4 * q + 2, 4 * q + 1, 4 * q + 3]]
            dx = _wgmma(frag, _wgmma_b(gyt_tile, kk * 2 * CORE, SBO_ROWS, P),
                        dx)
            db = _wgmma(frag, _wgmma_b(ct_tile, kk * 2 * CORE, SBO_ROWS, N),
                        db)
        np.testing.assert_allclose(_from_wgmma(dx), M[rows] @ gy, atol=1e-12)
        np.testing.assert_allclose(_from_wgmma(db), M[rows] @ Cm, atol=1e-12)
        # the D tile from the slots: value (j, i) at core_index(i, j)
        for w in range(4):
            for lane in range(32):
                for el in range(nc // 2):
                    j, i = row[w, lane, el], col[w, lane, el]
                    d_tile[_core_index(i, j, ROWS)] = M[j, i]
                    if wg:
                        d_tile[_core_index(i - 64, j, ROWS)] = 0.0
    assert not np.isnan(d_tile).any()
    # B^T D: A = B^T (rows n of a warpgroup's 64, K = j: a0 (n, j), a1
    # (n + 8, j), a2 (n, j + 4), a3 (n + 8, j + 4), j = 8 kk + t)
    for wg in range(-(-N // 64)):
        bt = np.pad(Bm.T, ((0, 128 - N), (0, 0)))[64 * wg:64 * wg + 64]
        acc = np.zeros((4, 32, ROWS // 2))
        for kk in range(ROWS // 8):
            acc = _wgmma(_fragments(bt[:, 8 * kk:8 * kk + 8]), _wgmma_b(
                d_tile, kk * 2 * CORE, SBO_ROWS, ROWS), acc)
        np.testing.assert_allclose(_from_wgmma(acc), bt @ M, atol=1e-12)
