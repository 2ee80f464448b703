"""Attention: GQA prefill (dense and blocked flash branches) and cached
one-token decode.

Prefill follows the JAX package's switch: the dense branch while
``S * Skv <= FLASH_THRESHOLD**2``, the blocked flash path past it.  The
flash path is the hand-written CUDA kernel for CUDA tensors
(:func:`repro_torch.kernels.ops.flash_attention`) and the plain chunked
online softmax (:func:`chunked_flash_attention`, differentiable through
autograd) on the CPU or when a caller asks for the plain version.
Decode supports the f32 linear cache with tracked ``kv_positions`` — no
ring buffer, window, int8 KV or decode chunks yet.

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


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, *, lead: tuple = (),
                   dtype=torch.float32) -> dict:
    return {
        "wq": layers.dense_init(gen, d_model, n_heads * head_dim, lead=lead,
                                dtype=dtype),
        "wk": layers.dense_init(gen, d_model, n_kv_heads * head_dim,
                                lead=lead, dtype=dtype),
        "wv": layers.dense_init(gen, d_model, n_kv_heads * head_dim,
                                lead=lead, dtype=dtype),
        "wo": layers.dense_init(gen, n_heads * head_dim, d_model, lead=lead,
                                dtype=dtype),
    }


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
) -> torch.Tensor:
    """Unblocked attention (short sequences and decode)."""
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
    q_chunk: int = 512,
    kv_chunk: int = 512,
) -> torch.Tensor:
    """Two-level blocked attention with online softmax (O(chunk^2) memory):
    the JAX package's ``chunked_flash_attention`` with its two ``scan``s as
    Python loops, the same arithmetic block by block.  Every kv chunk is
    visited, masked blocks included, as there."""
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
    """The flash kernel masks by row index, so it stands for positions
    ``arange(S)`` only (every prefill of the port passes those); other
    positions raise rather than be mis-masked."""
    if tuple(positions.shape) != (S,) or not bool(torch.equal(
            positions, torch.arange(S, device=positions.device,
                                    dtype=positions.dtype))):
        raise NotImplementedError(
            f"attention over {S} tokens on CUDA runs the flash kernel, which "
            "takes positions arange(S) only; these positions have no "
            "kernel path yet")


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
    use_kernel: bool = True,
):
    """Full-sequence attention (prefill).  Returns (out, (k, v)).
    ``use_kernel=False`` takes the plain chunked path past the threshold
    on any device (comparison runs)."""
    B, S, _ = x.shape
    long = S * S > FLASH_THRESHOLD * FLASH_THRESHOLD
    on_kernel = long and use_kernel and x.is_cuda
    if positions is None:
        positions = torch.arange(S, device=x.device)
    elif on_kernel:
        _require_arange(positions, S)
    q = layers.matmul(x, params["wq"]).reshape(B, S, n_heads, head_dim)
    k = layers.matmul(x, params["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = layers.matmul(x, params["wv"]).reshape(B, S, n_kv_heads, head_dim)
    if rope_theta is not None:
        q = layers.apply_rope(q, positions, rope_theta)
        k = layers.apply_rope(k, positions, rope_theta)
    if not long:
        out = dense_attention(q, k, v, causal=causal, q_positions=positions,
                              kv_positions=positions)
    elif on_kernel:  # (B, S, H, hd) in and out, as transposed views
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2),
                                  causal=causal).transpose(1, 2)
    else:
        out = chunked_flash_attention(
            q, k, v, causal=causal, q_positions=positions,
            kv_positions=positions, q_chunk=_pick_chunk(S, 512),
            kv_chunk=_pick_chunk(S, 512))
    return layers.matmul(out.reshape(B, S, n_heads * head_dim),
                         params["wo"]), (k, v)


def decode_attention_apply(
    params: dict,
    x: torch.Tensor,  # (B, 1, d_model)
    cache_k: torch.Tensor,  # (B, S_cache, Kv, hd) f32
    cache_v: torch.Tensor,
    cache_index: torch.Tensor,  # (B,) write position per stream
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    kv_positions: torch.Tensor,  # (B, S_cache); -1 marks an unwritten slot
    rope_theta: Optional[float] = 10000.0,
    position: Optional[torch.Tensor] = None,  # (B,); defaults to cache_index
):
    """One-token cached decode.  Returns (attn_out, cache_k, cache_v,
    kv_positions).

    The new K/V rows are written into ``cache_k``/``cache_v`` IN PLACE (the
    JAX package returns new arrays; the caches here are owned by the
    caller's session or slot, so writing in place saves a copy per step).
    ``kv_positions`` is returned as a new tensor.  A write index past the
    cache end is clamped to the last slot, as the JAX package's
    ``dynamic_update_slice`` clamps: idle serving slots keep advancing
    their index, and their output is discarded."""
    B = x.shape[0]
    S_cache = cache_k.shape[1]
    if position is None:
        position = cache_index
    pos = position.reshape(B, 1)

    q = layers.matmul(x, params["wq"]).reshape(B, 1, n_heads, head_dim)
    k_new = layers.matmul(x, params["wk"]).reshape(B, 1, n_kv_heads,
                                                   head_dim)
    v_new = layers.matmul(x, params["wv"]).reshape(B, 1, n_kv_heads,
                                                   head_dim)
    if rope_theta is not None:
        q = layers.apply_rope(q, pos, rope_theta)
        k_new = layers.apply_rope(k_new, pos, rope_theta)

    rows = torch.arange(B, device=x.device)
    slot = torch.clamp(cache_index, 0, S_cache - 1)
    cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)
    kpos = kv_positions.clone()
    kpos[rows, slot] = position.to(kpos.dtype)
    kv_valid = (kpos >= 0) & (kpos <= pos)

    out = dense_attention(q, cache_k, cache_v, causal=True, q_positions=pos,
                          kv_positions=kpos, kv_valid=kv_valid)
    attn = layers.matmul(out.reshape(B, 1, n_heads * head_dim),
                         params["wo"])
    return attn, cache_k, cache_v, kpos
