"""A numpy model of the port's TF32 tensor-core arithmetic and operand
layout (``src/repro_torch/kernels/csrc/tf32_wgmma.cuh``), shared by the
models of the flash-attention and SSD chunk kernels in
``tests/test_torch_flash.py`` and ``tests/test_torch_ssd.py``.

The 3xTF32 split: round to nearest with ties away (``cvt.rna.tf32.f32``),
hi = tf32(x), lo = tf32(x - hi), a product accumulated as a_lo b_hi +
a_hi b_lo + a_hi b_hi in 8-deep k-steps.  The layout: K-major operand
tiles of 8 x 16-byte core matrices without swizzle, read through wgmma
descriptors (LBO 128 bytes, SBO one row group), wgmma m64nNk8's A
fragments and f32 accumulator by lane.
"""
import numpy as np


def _tf32(x):
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, ties away from zero
    (a carry into the exponent is the right rounding too)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    """hi = tf32(x), lo = tf32(x - hi), the difference taken in f32."""
    x = np.asarray(x, np.float32)
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _tf32_product(a, b, passes):
    """a (M, K) @ b (K, N) as the kernel issues it: 8-deep k-steps, each
    accumulated in f32 as a_lo b_hi + a_hi b_lo + a_hi b_hi (small terms
    first); ``passes=1`` is a single TF32 pass, a_hi b_hi."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    terms = ([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if passes == 3
             else [(a_hi, b_hi)])
    c = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            c += x[:, k0:k0 + 8] @ y[k0:k0 + 8]
    return c


def _lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4


CORE = 32  # TF32 values in one wgmma core matrix: 8 rows of 16 bytes


def _core_index(r, k, kd):
    """Where TF32 value (r, k) of a K-major operand tile with ``kd``
    columns along K lives in the kernel's shared memory: core matrix
    (r // 8, k // 4), its row r % 8, column k % 4."""
    return ((r // 8) * (kd // 4) + k // 4) * CORE + (r % 8) * 4 + k % 4


def _wgmma_b(smem, start, sbo, n):
    """The 8 x n B operand (K-major, no swizzle) that a wgmma reads from
    flat shared memory (in 4-byte words) through a descriptor: value (k,
    j) at start + (j // 8) * SBO + (k // 4) * LBO + (j % 8) * 16 bytes +
    (k % 4) * 4 bytes, with LBO 128 bytes (CUTLASS's canonical K-major
    INTERLEAVE layout ((8, n), 2) : ((1, SBO), LBO) in 16-byte units)."""
    k, j = np.meshgrid(np.arange(8), np.arange(n), indexing="ij")
    words = start + (j // 8) * (sbo // 4) + (k // 4) * (128 // 4) + \
        (j % 8) * 4 + k % 4
    return smem[words]


def _wgmma(a, b, d):
    """wgmma m64nNk8: per warp w, its 16 rows of A (A fragments a (4, 32,
    4), lane 4g + t holding (g, t), (g+8, t), (g, t+4), (g+8, t+4)) times
    b (8, N), accumulated into d (4, 32, N // 2) in the accumulator order
    (per 8 columns i: (g, 8i+2t), (g, 8i+2t+1), (g+8, 8i+2t),
    (g+8, 8i+2t+1))."""
    g, t = _lanes()
    out = d.copy()
    for w in range(4):
        A = np.zeros((16, 8))
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[w].T
        C = A @ b
        for i in range(b.shape[1] // 8):
            out[w, :, 4 * i] += C[g, 8 * i + 2 * t]
            out[w, :, 4 * i + 1] += C[g, 8 * i + 2 * t + 1]
            out[w, :, 4 * i + 2] += C[g + 8, 8 * i + 2 * t]
            out[w, :, 4 * i + 3] += C[g + 8, 8 * i + 2 * t + 1]
    return out


def _from_wgmma(d):
    """(64, N) from wgmma accumulator fragments (4, 32, N // 2)."""
    g, t = _lanes()
    out = np.zeros((64, d.shape[2] * 2))
    for w in range(4):
        for i in range(d.shape[2] // 4):
            rows, cols = 16 * w + g, 8 * i + 2 * t
            out[rows, cols], out[rows, cols + 1] = d[w, :, 4 * i], \
                d[w, :, 4 * i + 1]
            out[rows + 8, cols], out[rows + 8, cols + 1] = \
                d[w, :, 4 * i + 2], d[w, :, 4 * i + 3]
    return out


def _fragments(A):
    """A 64 x 8 matrix as wgmma's A fragments (4, 32, 4): warp w's lane
    4g + t holds (16w + g, t), (16w + g + 8, t), (16w + g, t + 4),
    (16w + g + 8, t + 4)."""
    g, t = _lanes()
    return np.stack([np.stack([A[16 * w + g, t], A[16 * w + g + 8, t],
                               A[16 * w + g, t + 4],
                               A[16 * w + g + 8, t + 4]], axis=1)
                     for w in range(4)])
