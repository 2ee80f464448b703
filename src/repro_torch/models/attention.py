"""Attention: GQA prefill (dense and blocked flash branches), cross
attention and cached one-token decode.

Prefill follows the JAX package's switch: the dense branch while
``S * Skv <= FLASH_THRESHOLD**2``, the blocked flash path past it.  The
flash path is the hand-written CUDA kernel for CUDA tensors
(:func:`repro_torch.kernels.ops.flash_attention`), differentiable: when
the inputs require grad (training) the forward also writes each row's
logsumexp and autograd runs the hand-written backward kernels.  On the
CPU, or when a caller asks for the plain version, it is the plain chunked
online softmax (:func:`chunked_flash_attention`, with the JAX package's
structure, differentiable through autograd).
Cross attention (``kv_override``: K, V and their positions from the
encoder, no RoPE on k) and a sliding ``window`` take the same switch on
``S * Skv``; past it on the card two cases have no kernel and raise by
name: cross attention with ``Sq != Skv`` and a window (the kernel takes
one sequence and masks causally or not at all).  Decode writes one row
into a linear or a ring cache (slot = index mod
``S_cache``) with tracked ``kv_positions``, under an optional sliding
``window``; the cache may be int8 with per-vector f32 scales
(:func:`quantize_kv`), and the attention over it may be split into
flash-decoding chunks (:func:`chunked_decode_attention`).  Decode
attention is plain PyTorch, as it is plain ``jnp`` in the JAX package.

Decode is written for a batch of independent streams, each at its own
position: ``cache_index`` is a ``(B,)`` tensor and ``kv_positions`` a
``(B, S_cache)`` tensor.  This is how the serving driver decodes its slots
together (the JAX package ``vmap``s a B=1 decode over a slot axis).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers

NEG_INF = -1e30
FLASH_THRESHOLD = 2048
# qk-norm's eps: the JAX package normalises q and k at 1e-6 in the
# full-sequence attention and at ``rmsnorm``'s default 1e-5 in the
# one-token decode.  Both are kept as they are.
QK_NORM_PREFILL_EPS = 1e-6
QK_NORM_DECODE_EPS = 1e-5


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, *, qk_norm: bool = False,
                   lead: tuple = (), dtype=torch.float32) -> dict:
    """The four projections; ``qk_norm`` adds an RMSNorm over ``head_dim``
    for q and for k (``q_norm``, ``k_norm``), as in the JAX package."""
    p = {
        "wq": layers.dense_init(gen, d_model, n_heads * head_dim, lead=lead,
                                dtype=dtype),
        "wk": layers.dense_init(gen, d_model, n_kv_heads * head_dim,
                                lead=lead, dtype=dtype),
        "wv": layers.dense_init(gen, d_model, n_kv_heads * head_dim,
                                lead=lead, dtype=dtype),
        "wo": layers.dense_init(gen, n_heads * head_dim, d_model, lead=lead,
                                dtype=dtype),
    }
    if qk_norm:
        p["q_norm"] = layers.init_rmsnorm(head_dim, lead=lead,
                                          device=gen.device, dtype=dtype)
        p["k_norm"] = layers.init_rmsnorm(head_dim, lead=lead,
                                          device=gen.device, dtype=dtype)
    return p


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def _batched_positions(pos: torch.Tensor, B: int) -> torch.Tensor:
    return pos.expand(B, pos.shape[-1]) if pos.ndim == 1 else pos


def dense_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, Kv, hd)
    v: torch.Tensor,  # (B, Skv, Kv, hd)
    *,
    causal: bool,
    q_positions: torch.Tensor,  # (Sq,) or (B, Sq)
    kv_positions: torch.Tensor,  # (Skv,) or (B, Skv)
    kv_valid: Optional[torch.Tensor] = None,  # (B, Skv) bool
    window: Optional[int] = None,
) -> torch.Tensor:
    """Unblocked attention (short sequences and decode); ``window`` keeps
    the keys with ``qpos - kpos < window``."""
    B, Sq, H, hd = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, Sq, Kv, H // Kv, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float())
    scores = scores * (1.0 / hd ** 0.5)  # (B, Kv, rep, Sq, Skv) f32

    qpos = _batched_positions(q_positions, B)
    kpos = _batched_positions(kv_positions, B)
    mask = torch.ones((B, Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos[:, :, None] >= kpos[:, None, :])
    if window is not None:
        mask = mask & (qpos[:, :, None] - kpos[:, None, :] < window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def chunked_flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, Kv, hd)
    v: torch.Tensor,
    *,
    causal: bool,
    q_positions: torch.Tensor,  # (Sq,)
    kv_positions: torch.Tensor,  # (Skv,)
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 512,
) -> torch.Tensor:
    """Two-level blocked attention with online softmax (O(chunk^2) memory):
    the JAX package's ``chunked_flash_attention`` with its two ``scan``s as
    Python loops, the same arithmetic block by block.  Every kv chunk is
    visited, masked blocks included, as there; ``window`` keeps the keys
    with ``qpos - kpos < window``."""
    B, Sq, H, hd = q.shape
    Skv, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"chunks must tile the sequences: Sq {Sq} by "
                         f"{q_chunk}, Skv {Skv} by {kv_chunk}")
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = 1.0 / hd ** 0.5

    qpos = q_positions.reshape(nq, q_chunk)
    kpos = kv_positions.reshape(nk, kv_chunk)
    qg = q.reshape(B, nq, q_chunk, Kv, rep, hd)
    kg = k.reshape(B, nk, kv_chunk, Kv, hd)
    vg = v.reshape(B, nk, kv_chunk, Kv, hd)

    chunks = []
    for qi in range(nq):
        q_blk = qg[:, qi].to(torch.float32)  # (B, Cq, Kv, rep, hd)
        acc = torch.zeros((B, Kv, rep, q_chunk, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, Kv, rep, q_chunk), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Kv, rep, q_chunk), dtype=torch.float32,
                        device=q.device)
        for ki in range(nk):
            s = torch.einsum("bqgrd,bkgd->bgrqk", q_blk,
                             kg[:, ki].to(torch.float32)) * scale
            if causal:
                s = s.masked_fill(qpos[qi][:, None] < kpos[ki][None, :],
                                  NEG_INF)
            if window is not None:
                s = s.masked_fill(
                    qpos[qi][:, None] - kpos[ki][None, :] >= window, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p, vg[:, ki].to(torch.float32))
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        chunks.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(chunks, dim=1).reshape(B, Sq, H, hd)


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (chunking must tile exactly)."""
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return 1


def _require_arange(positions: torch.Tensor, S: int) -> None:
    """The flash kernel masks causally by row index, which for a
    self-attention equals the position mask when the positions are one
    contiguous run ``p0 + arange(S)`` (every prefill of the port passes
    ``arange(S)``; the vlm text tower ``Sv + arange(S)``); other positions
    raise rather than be mis-masked."""
    if tuple(positions.shape) != (S,) or not bool(torch.equal(
            positions - positions[0],
            torch.arange(S, device=positions.device,
                         dtype=positions.dtype))):
        raise NotImplementedError(
            f"causal attention over {S} tokens on CUDA runs the flash "
            "kernel, which takes one contiguous run of positions p0 + "
            "arange(S) only; these positions have no kernel path yet")


def attention_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, d_model)
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,  # (S,)
    rope_theta: Optional[float] = 10000.0,
    window: Optional[int] = None,
    kv_override=None,  # (k, v, kv_positions) for cross-attention
    use_kernel: bool = True,
):
    """Full-sequence attention (prefill).  Returns (out, (k, v)).
    With qk-norm params, q and k are normalised per head before RoPE at
    ``QK_NORM_PREFILL_EPS``.  ``kv_override=(k, v, kv_positions)`` is
    cross attention: q from ``x``, K and V as given (``(B, Skv, Kv,
    hd)``), RoPE on q only.  ``window`` keeps the keys with ``qpos - kpos
    < window``.  Past the threshold on CUDA the flash kernels run forward
    and, under autograd, backward.  ``use_kernel=False`` takes the plain
    chunked path past the threshold on any device (comparison runs; under
    autograd it keeps every block's scores for the backward)."""
    B, S, _ = x.shape
    Skv = S if kv_override is None else kv_override[0].shape[1]
    long = S * Skv > FLASH_THRESHOLD * FLASH_THRESHOLD
    on_kernel = long and use_kernel and x.is_cuda
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if on_kernel:
        if window is not None:
            raise NotImplementedError(
                f"windowed attention over {S} x {Skv} tokens on CUDA: the "
                "flash kernel has no window (ROADMAP.md Queue 1)")
        if Skv != S:
            raise NotImplementedError(
                f"cross attention of {S} queries over {Skv} keys on CUDA: "
                "the flash kernel takes one sequence length "
                "(ROADMAP.md Queue 1)")
        if causal:
            _require_arange(positions, S)
    q = layers.matmul(x, params["wq"]).reshape(B, S, n_heads, head_dim)
    if kv_override is None:
        k = layers.matmul(x, params["wk"]).reshape(B, S, n_kv_heads,
                                                   head_dim)
        v = layers.matmul(x, params["wv"]).reshape(B, S, n_kv_heads,
                                                   head_dim)
        kv_positions = positions
    else:
        k, v, kv_positions = kv_override
    if "q_norm" in params:
        q = layers.rmsnorm(params["q_norm"], q, QK_NORM_PREFILL_EPS)
        k = layers.rmsnorm(params["k_norm"], k, QK_NORM_PREFILL_EPS)
    if rope_theta is not None:
        q = layers.apply_rope(q, positions, rope_theta)
        if kv_override is None:
            k = layers.apply_rope(k, kv_positions, rope_theta)
    if not long:
        out = dense_attention(q, k, v, causal=causal, q_positions=positions,
                              kv_positions=kv_positions, window=window)
    elif on_kernel:  # (B, S, H, hd) in and out, as transposed views
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2),
                                  causal=causal).transpose(1, 2)
    else:
        out = chunked_flash_attention(
            q, k, v, causal=causal, q_positions=positions,
            kv_positions=kv_positions, window=window,
            q_chunk=_pick_chunk(S, 512), kv_chunk=_pick_chunk(Skv, 512))
    return layers.matmul(out.reshape(B, S, n_heads * head_dim),
                         params["wo"]), (k, v)


def quantize_kv(x: torch.Tensor, dim: int = -1):
    """Per-vector symmetric int8 quantization: returns (q int8, scale f32)
    with ``scale = max(amax, 1e-8) / 127`` of shape ``(..., 1)``; rounds
    half to even and clips to +-127, as the JAX package does."""
    x32 = x.float()
    amax = torch.amax(torch.abs(x32), dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _refuse_chunk_sharding(chunk_sharding) -> None:
    if chunk_sharding is not None:
        raise NotImplementedError(
            "chunk_sharding is an XLA sharding constraint on the chunked "
            "cache view; the port runs on one card and has no counterpart "
            "yet (ROADMAP.md Queue 1 item 15, the multi-GPU modules)")


def decode_attention_apply(
    params: dict,
    x: torch.Tensor,  # (B, 1, d_model)
    cache_k: torch.Tensor,  # (B, S_cache, Kv, hd): f32/bf16, or int8
    cache_v: torch.Tensor,
    cache_index: torch.Tensor,  # (B,) write position per stream
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    kv_positions: Optional[torch.Tensor],  # (B, S_cache); -1: unwritten
    rope_theta: Optional[float] = 10000.0,
    position: Optional[torch.Tensor] = None,  # (B,); defaults to cache_index
    window: Optional[int] = None,
    ring: bool = False,  # ring-buffer cache (sliding window)
    decode_chunks: Optional[int] = None,  # flash-decoding chunk count
    chunk_sharding=None,
    kv_scales=None,  # (k_scale, v_scale): (B, S_cache, Kv, 1) f32, int8
    cross: bool = False,  # cross-attention: read-only cache, no RoPE on k
):
    """One-token cached decode.  Returns (attn_out, cache_k, cache_v,
    kv_positions, kv_scales).

    ``cross``: attention over a read-only cache (the encoder's K/V) at
    ``kv_positions``, ``arange(S_cache)`` when None, with no causal mask
    and nothing written; RoPE (when given) on q only.  Returns the caches
    as given, those positions and no scales, as the JAX package does.

    The new K/V rows (and, for an int8 cache, their scales) are written
    into the caches IN PLACE (the JAX package returns new arrays; the
    caches here are owned by the caller's session or slot, so writing in
    place saves a copy per step).  ``kv_positions`` is returned as a new
    tensor.  A ring cache writes slot ``index mod S_cache``; a linear
    cache clamps a write index past its end to the last slot, as the JAX
    package's ``dynamic_update_slice`` clamps: idle serving slots keep
    advancing their index, and their output is discarded."""
    _refuse_chunk_sharding(chunk_sharding)
    B = x.shape[0]
    S_cache = cache_k.shape[1]
    if position is None:
        position = cache_index
    pos = position.reshape(B, 1)

    q = layers.matmul(x, params["wq"]).reshape(B, 1, n_heads, head_dim)
    if cross:
        if "q_norm" in params:
            q = layers.rmsnorm(params["q_norm"], q, QK_NORM_DECODE_EPS)
        if rope_theta is not None:
            q = layers.apply_rope(q, pos, rope_theta)
        kpos = torch.arange(S_cache, device=x.device) \
            if kv_positions is None else kv_positions
        out = dense_attention(q, cache_k, cache_v, causal=False,
                              q_positions=pos, kv_positions=kpos,
                              window=window)
        attn = layers.matmul(out.reshape(B, 1, n_heads * head_dim),
                             params["wo"])
        return attn, cache_k, cache_v, kpos, None
    k_new = layers.matmul(x, params["wk"]).reshape(B, 1, n_kv_heads,
                                                   head_dim)
    v_new = layers.matmul(x, params["wv"]).reshape(B, 1, n_kv_heads,
                                                   head_dim)
    if "q_norm" in params:
        q = layers.rmsnorm(params["q_norm"], q, QK_NORM_DECODE_EPS)
        k_new = layers.rmsnorm(params["k_norm"], k_new, QK_NORM_DECODE_EPS)
    if rope_theta is not None:
        q = layers.apply_rope(q, pos, rope_theta)
        k_new = layers.apply_rope(k_new, pos, rope_theta)

    rows = torch.arange(B, device=x.device)
    if ring:
        slot = torch.remainder(cache_index, S_cache)
    else:
        slot = torch.clamp(cache_index, 0, S_cache - 1)
    if kv_scales is not None:
        k_q, k_s = quantize_kv(k_new)
        v_q, v_s = quantize_kv(v_new)
        cache_k[rows, slot] = k_q[:, 0]
        cache_v[rows, slot] = v_q[:, 0]
        kv_scales[0][rows, slot] = k_s[:, 0]
        kv_scales[1][rows, slot] = v_s[:, 0]
    else:
        cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)
    kpos = kv_positions.clone()
    kpos[rows, slot] = position.to(kpos.dtype)

    if decode_chunks:
        out = chunked_decode_attention(
            q, cache_k, cache_v, kpos, position, n_chunks=decode_chunks,
            window=window, kv_scales=kv_scales)
    else:
        k_use, v_use = cache_k, cache_v
        if kv_scales is not None:
            k_use = dequantize_kv(cache_k, kv_scales[0]).to(q.dtype)
            v_use = dequantize_kv(cache_v, kv_scales[1]).to(q.dtype)
        kv_valid = (kpos >= 0) & (kpos <= pos)
        out = dense_attention(q, k_use, v_use, causal=True, q_positions=pos,
                              kv_positions=kpos, kv_valid=kv_valid,
                              window=window)
    attn = layers.matmul(out.reshape(B, 1, n_heads * head_dim),
                         params["wo"])
    return attn, cache_k, cache_v, kpos, kv_scales


def chunked_decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k: torch.Tensor,  # (B, S, Kv, hd)
    v: torch.Tensor,
    kv_positions: torch.Tensor,  # (B, S)
    position: torch.Tensor,  # (B,)
    *,
    n_chunks: int,
    window: Optional[int] = None,
    chunk_sharding=None,
    kv_scales=None,  # (k_scale, v_scale): (B, S, Kv, 1), int8 k and v
) -> torch.Tensor:
    """Flash-decoding layout: the KV sequence is split into ``n_chunks``
    blocks, each block computes a partial softmax, and the partials
    combine by log-sum-exp; a chunk with no valid key gets zero weight.
    Per stream (``position`` and ``kv_positions`` carry the batch axis).
    Returns ``(B, 1, H, hd)``."""
    _refuse_chunk_sharding(chunk_sharding)
    B, S, Kv, hd = k.shape
    H = q.shape[2]
    rep = H // Kv
    if S % n_chunks:
        raise ValueError(f"decode_chunks={n_chunks} must divide the cache "
                         f"length {S}")
    Sc = S // n_chunks
    kc = k.reshape(B, n_chunks, Sc, Kv, hd)
    vc = v.reshape(B, n_chunks, Sc, Kv, hd)
    if kv_scales is not None:
        kc = dequantize_kv(kc, kv_scales[0].reshape(B, n_chunks, Sc, Kv,
                                                    1)).to(q.dtype)
        vc = dequantize_kv(vc, kv_scales[1].reshape(B, n_chunks, Sc, Kv,
                                                    1)).to(q.dtype)
    pc = kv_positions.reshape(B, n_chunks, Sc)
    p_now = position.reshape(B, 1, 1)

    qg = q.reshape(B, Kv, rep, hd)
    s = torch.einsum("bgrd,bcsgd->bcgrs", qg.float(), kc.float())
    s = s * (1.0 / hd ** 0.5)  # (B, nc, Kv, rep, Sc) f32
    valid = (pc >= 0) & (pc <= p_now)
    if window is not None:
        valid = valid & (pc > p_now - window)
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    m_c = torch.amax(s, dim=-1)  # (B, nc, Kv, rep)
    p = torch.exp(s - m_c[..., None])
    alive = torch.any(valid, dim=-1)[:, :, None, None]  # (B, nc, 1, 1)
    p = torch.where(alive[..., None], p, torch.zeros_like(p))
    num_c = torch.einsum("bcgrs,bcsgd->bcgrd", p, vc.float())
    den_c = torch.sum(p, dim=-1)

    m = torch.amax(m_c, dim=1, keepdim=True)
    w = torch.where(alive, torch.exp(m_c - m), torch.zeros_like(m_c))
    num = torch.sum(num_c * w[..., None], dim=1)  # (B, Kv, rep, hd)
    den = torch.clamp(torch.sum(den_c * w, dim=1), min=1e-30)
    out = num / den[..., None]
    return out.reshape(B, 1, H, hd).to(q.dtype)
