"""Dense transformer blocks and stacks.

Params for L homogeneous layers are stacked on a leading axis, as in the
JAX package; a Python loop over the layers takes the place of
``lax.scan``.  The vertical-SplitNN towers are built from the same blocks
at width d_model/K.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers


@dataclass(frozen=True)
class BlockDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    rope_theta: Optional[float] = 10000.0
    norm_eps: float = 1e-5

    @staticmethod
    def from_arch(cfg: ArchConfig) -> "BlockDims":
        if cfg.family != "dense" or cfg.qk_norm:
            raise NotImplementedError(
                f"{cfg.name}: the port's transformer blocks cover the dense "
                "family without qk-norm so far")
        return BlockDims(
            d_model=cfg.d_model,
            n_heads=cfg.num_heads,
            n_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim(),
            d_ff=cfg.d_ff,
            rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps,
        )

    def scaled(self, k: int) -> "BlockDims":
        """Tower dims: width/heads divided by the client count."""
        heads = max(1, self.n_heads // k)
        kv = max(1, self.n_kv_heads // k)
        while heads % kv:
            kv -= 1
        return BlockDims(
            d_model=heads * self.head_dim,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=self.head_dim,
            d_ff=max(self.head_dim, self.d_ff // k),
            rope_theta=self.rope_theta,
            norm_eps=self.norm_eps,
        )


def layer_params(stacked, index: int):
    """Layer ``index`` of a stacked param tree."""
    if isinstance(stacked, dict):
        return {key: layer_params(val, index) for key, val in stacked.items()}
    return stacked[index]


def num_layers(stacked) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


# ---------------------------------------------------------------------------
# dense block
# ---------------------------------------------------------------------------

def init_dense_block(gen: torch.Generator, dims: BlockDims, *,
                     lead: tuple = (), dtype=torch.float32) -> dict:
    """One pre-norm block; ``lead=(L,)`` draws a stack of L at once."""
    return {
        "ln1": layers.init_rmsnorm(dims.d_model, lead=lead,
                                   device=gen.device, dtype=dtype),
        "attn": attn_lib.init_attention(
            gen, dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim,
            lead=lead, dtype=dtype),
        "ln2": layers.init_rmsnorm(dims.d_model, lead=lead,
                                   device=gen.device, dtype=dtype),
        "mlp": layers.init_gated_mlp(gen, dims.d_model, dims.d_ff,
                                     lead=lead, dtype=dtype),
    }


def dense_block_apply(p: dict, x: torch.Tensor, dims: BlockDims, *,
                      causal: bool = True, positions=None,
                      return_kv: bool = False):
    """Full-sequence forward."""
    h = layers.rmsnorm(p["ln1"], x, dims.norm_eps)
    attn_out, kv = attn_lib.attention_apply(
        p["attn"], h, n_heads=dims.n_heads, n_kv_heads=dims.n_kv_heads,
        head_dim=dims.head_dim, causal=causal, positions=positions,
        rope_theta=dims.rope_theta)
    x = x + attn_out
    h = layers.rmsnorm(p["ln2"], x, dims.norm_eps)
    out = x + layers.gated_mlp(p["mlp"], h)
    if return_kv:
        return out, kv
    return out


def dense_stack_prefill(stacked: dict, x: torch.Tensor, dims: BlockDims, *,
                        positions: torch.Tensor, causal: bool = True):
    """Full-sequence forward that also returns per-layer K/V for cache fill.
    Returns (x, ks, vs) with ks/vs: (L, B, S, Kv, hd)."""
    ks, vs = [], []
    for i in range(num_layers(stacked)):
        x, (k, v) = dense_block_apply(layer_params(stacked, i), x, dims,
                                      causal=causal, positions=positions,
                                      return_kv=True)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def dense_block_decode(p: dict, x: torch.Tensor, cache_k, cache_v, index,
                       kv_positions, dims: BlockDims, *, position=None):
    """One-token decode.  Returns (x, cache_k, cache_v, kv_positions); the
    caches are written in place (see ``decode_attention_apply``)."""
    h = layers.rmsnorm(p["ln1"], x, dims.norm_eps)
    attn_out, nk, nv, npos = attn_lib.decode_attention_apply(
        p["attn"], h, cache_k, cache_v, index, n_heads=dims.n_heads,
        n_kv_heads=dims.n_kv_heads, head_dim=dims.head_dim,
        kv_positions=kv_positions, rope_theta=dims.rope_theta,
        position=position)
    x = x + attn_out
    h = layers.rmsnorm(p["ln2"], x, dims.norm_eps)
    return x + layers.gated_mlp(p["mlp"], h), nk, nv, npos


def dense_stack_decode(stacked: dict, x: torch.Tensor, cache_k: torch.Tensor,
                       cache_v: torch.Tensor, index: torch.Tensor,
                       kv_positions: torch.Tensor, dims: BlockDims, *,
                       position: Optional[torch.Tensor] = None):
    """cache_k/v: (L, B, S, Kv, hd), written in place; index: (B,);
    kv_positions: (B, S).  Returns (x, cache_k, cache_v, kv_positions) —
    the new positions are the same for every layer, so layer 0's are
    kept, as in the JAX package."""
    npos = kv_positions
    for i in range(num_layers(stacked)):
        x, _, _, pos_i = dense_block_decode(
            layer_params(stacked, i), x, cache_k[i], cache_v[i], index,
            kv_positions, dims, position=position)
        if i == 0:
            npos = pos_i
    return x, cache_k, cache_v, npos
