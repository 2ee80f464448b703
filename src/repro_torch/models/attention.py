"""Attention: GQA prefill (dense branch) and cached one-token decode.

Prefill takes the JAX package's dense branch (``S * Skv <=
FLASH_THRESHOLD**2``); longer sequences need the blocked flash path,
which comes with the flash-attention slice and raises here.  Decode
supports the f32 linear cache with tracked ``kv_positions`` — no ring
buffer, window, int8 KV or decode chunks in this slice.

Decode is written for a batch of independent streams, each at its own
position: ``cache_index`` is a ``(B,)`` tensor and ``kv_positions`` a
``(B, S_cache)`` tensor.  This is how the serving driver decodes its slots
together (the JAX package ``vmap``s a B=1 decode over a slot axis).
"""
from __future__ import annotations

from typing import Optional

import torch

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
):
    """Full-sequence attention (prefill).  Returns (out, (k, v))."""
    B, S, _ = x.shape
    if S * S > FLASH_THRESHOLD * FLASH_THRESHOLD:
        raise NotImplementedError(
            f"attention over {S} tokens takes the blocked flash path "
            f"(S*Skv > {FLASH_THRESHOLD}**2), which comes with the "
            "flash-attention slice of the port")
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(B, S, n_kv_heads, head_dim)
    if rope_theta is not None:
        q = layers.apply_rope(q, positions, rope_theta)
        k = layers.apply_rope(k, positions, rope_theta)
    out = dense_attention(q, k, v, causal=causal, q_positions=positions,
                          kv_positions=positions)
    return out.reshape(B, S, n_heads * head_dim) @ params["wo"], (k, v)


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

    q = (x @ params["wq"]).reshape(B, 1, n_heads, head_dim)
    k_new = (x @ params["wk"]).reshape(B, 1, n_kv_heads, head_dim)
    v_new = (x @ params["wv"]).reshape(B, 1, n_kv_heads, head_dim)
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
    attn = out.reshape(B, 1, n_heads * head_dim) @ params["wo"]
    return attn, cache_k, cache_v, kpos
