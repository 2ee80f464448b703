"""Transformer, MoE and Mamba2 blocks and stacks, and the hybrid (zamba2)
stack: super-blocks of Mamba2 layers, each followed by one weight-shared
attention block, then the trailing Mamba2 layers.

The dense block takes the family's MLP and norm (``BlockDims.mlp`` and
``.norm``: SwiGLU and RMSNorm, or the audio family's GELU and LayerNorm
with no RoPE), a sliding ``window`` and, for the whisper decoder, a cross
attention over the encoder's K/V (``cross=True``: ``ln_cross`` and
``cross``).

Params for L homogeneous layers are stacked on a leading axis, as in the
JAX package; a Python loop over the layers takes the place of
``lax.scan``.  The vertical-SplitNN towers are built from the same blocks
at width d_model/K.

``remat`` (the stacks' full-sequence forwards) recomputes activations in
the backward pass: each layer (a hybrid's super-block, and each Mamba2
layer inside it) is one checkpointed unit, the JAX package's scan body
under ``jax.checkpoint``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, mamba
from repro_torch.models import moe as moe_lib


@dataclass(frozen=True)
class BlockDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    qk_norm: bool = False
    rope_theta: Optional[float] = 10000.0
    norm_eps: float = 1e-5
    mlp: str = "swiglu"  # "swiglu" | "gelu"
    norm: str = "rms"  # "rms" | "ln"

    @staticmethod
    def from_arch(cfg: ArchConfig) -> "BlockDims":
        """The attention dims: a hybrid's are its shared block's (real
        heads and ``d_ff``); an ssm (attention-free, ``num_heads`` 0) gets
        the JAX package's degenerate values, of which it reads only the
        norm fields.  The audio family's blocks are whisper's: GELU MLP,
        LayerNorm, no RoPE (sinusoidal positions are added to the
        input)."""
        audio = cfg.family == "audio"
        return BlockDims(
            d_model=cfg.d_model,
            n_heads=cfg.num_heads,
            n_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim(),
            d_ff=cfg.d_ff,
            qk_norm=cfg.qk_norm,
            rope_theta=None if audio else cfg.rope_theta,
            norm_eps=cfg.norm_eps,
            mlp="gelu" if audio else "swiglu",
            norm="ln" if audio else "rms",
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
            qk_norm=self.qk_norm,
            rope_theta=self.rope_theta,
            norm_eps=self.norm_eps,
            mlp=self.mlp,
            norm=self.norm,
        )


def init_norm(d: int, kind: str, *, lead: tuple = (), device=None,
              dtype=torch.float32) -> dict:
    if kind == "rms":
        return layers.init_rmsnorm(d, lead=lead, device=device, dtype=dtype)
    return layers.init_layernorm(d, lead=lead, device=device, dtype=dtype)


def norm(params: dict, x: torch.Tensor, kind: str, eps: float):
    if kind == "rms":
        return layers.rmsnorm(params, x, eps)
    return layers.layernorm(params, x, eps)


def stack_dtype(stacked) -> torch.dtype:
    """The dtype of a param tree's first leaf."""
    while isinstance(stacked, dict):
        stacked = stacked[sorted(stacked)[0]]
    return stacked.dtype


def layer_params(stacked, index: int):
    """Layer ``index`` of a stacked param tree."""
    if isinstance(stacked, dict):
        return {key: layer_params(val, index) for key, val in stacked.items()}
    return stacked[index]


def unstack_layers(stacked) -> list:
    """Every layer of a stacked param tree, from one ``unbind`` per leaf.
    Autograd then stacks the layers' gradients once; indexing layer by
    layer would give each layer a zero-filled gradient of the whole stack
    and sum L of them (on mamba2-1.3b's server, 46 adds of a 3.2 GB
    in_proj stack a step)."""
    if isinstance(stacked, dict):
        per_key = {key: unstack_layers(val) for key, val in stacked.items()}
        count = len(next(iter(per_key.values())))
        return [{key: layers_[i] for key, layers_ in per_key.items()}
                for i in range(count)]
    return list(torch.unbind(stacked, 0))


# the products without batch dimensions: the outputs that
# ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` keeps (every
# weight product; attention's and the SSD's batched products are not)
_SAVEABLE_DOTS = frozenset({torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVEABLE_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


def _maybe_checkpoint(body, remat):
    """remat: False | True (full: the unit keeps only its inputs and runs
    again in the backward pass) | "dots" (the unit also keeps the outputs
    of its products without batch dimensions; the backward pass re-runs
    the rest, the attention and SSD kernels included).  Non-reentrant
    ``torch.utils.checkpoint``: gradients flow to params the body closes
    over, and units nest.  The forward draws no random numbers, so no RNG
    state is kept for the recompute (``preserve_rng_state=False``)."""
    if not remat:
        return body
    context_fn = _dots_context if remat == "dots" else ckpt.noop_context_fn

    def unit(*args):
        return ckpt.checkpoint(body, *args, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=context_fn)

    return unit


def num_layers(stacked) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


# ---------------------------------------------------------------------------
# dense block
# ---------------------------------------------------------------------------

def init_dense_block(gen: torch.Generator, dims: BlockDims, *,
                     lead: tuple = (), dtype=torch.float32,
                     cross: bool = False) -> dict:
    """One pre-norm block; ``lead=(L,)`` draws a stack of L at once.
    ``cross`` adds the whisper decoder's cross attention (``ln_cross``,
    ``cross``: no qk-norm)."""
    dev = gen.device
    p = {
        "ln1": init_norm(dims.d_model, dims.norm, lead=lead, device=dev,
                         dtype=dtype),
        "attn": attn_lib.init_attention(
            gen, dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim,
            qk_norm=dims.qk_norm, lead=lead, dtype=dtype),
        "ln2": init_norm(dims.d_model, dims.norm, lead=lead, device=dev,
                         dtype=dtype),
        "mlp": (layers.init_gated_mlp if dims.mlp == "swiglu"
                else layers.init_gelu_mlp)(gen, dims.d_model, dims.d_ff,
                                           lead=lead, dtype=dtype),
    }
    if cross:
        p["ln_cross"] = init_norm(dims.d_model, dims.norm, lead=lead,
                                  device=dev, dtype=dtype)
        p["cross"] = attn_lib.init_attention(
            gen, dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim,
            lead=lead, dtype=dtype)
    return p


def _mlp_apply(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    return layers.gated_mlp(p, x) if kind == "swiglu" else \
        layers.gelu_mlp(p, x)


def dense_block_apply(p: dict, x: torch.Tensor, dims: BlockDims, *,
                      causal: bool = True, positions=None,
                      window: Optional[int] = None, cross_kv=None,
                      return_kv: bool = False, use_kernel: bool = True):
    """Full-sequence forward.  ``cross_kv=(k, v, kv_positions)``: the
    encoder's K/V for a block with a cross attention (non-causal, no
    RoPE).  ``use_kernel=False`` keeps long attention on the plain
    chunked path (see ``attention_apply``)."""
    h = norm(p["ln1"], x, dims.norm, dims.norm_eps)
    attn_out, kv = attn_lib.attention_apply(
        p["attn"], h, n_heads=dims.n_heads, n_kv_heads=dims.n_kv_heads,
        head_dim=dims.head_dim, causal=causal, positions=positions,
        rope_theta=dims.rope_theta, window=window, use_kernel=use_kernel)
    x = x + attn_out
    if cross_kv is not None and "cross" in p:
        h = norm(p["ln_cross"], x, dims.norm, dims.norm_eps)
        c_out, _ = attn_lib.attention_apply(
            p["cross"], h, n_heads=dims.n_heads, n_kv_heads=dims.n_kv_heads,
            head_dim=dims.head_dim, causal=False, positions=positions,
            rope_theta=None, kv_override=cross_kv, use_kernel=use_kernel)
        x = x + c_out
    h = norm(p["ln2"], x, dims.norm, dims.norm_eps)
    out = x + _mlp_apply(p["mlp"], h, dims.mlp)
    if return_kv:
        return out, kv
    return out


def dense_stack_apply(stacked: dict, x: torch.Tensor, dims: BlockDims, *,
                      causal: bool = True,
                      positions: Optional[torch.Tensor] = None,
                      window: Optional[int] = None, cross_kv=None,
                      use_kernel: bool = True, remat=False) -> torch.Tensor:
    """Full-sequence forward through L stacked layers, no cache (training,
    the monolithic forward and the split program's tower / server
    forwards); each layer one ``remat`` unit."""
    def body(h, params):
        return dense_block_apply(params, h, dims, causal=causal,
                                 positions=positions, window=window,
                                 cross_kv=cross_kv, use_kernel=use_kernel)

    body = _maybe_checkpoint(body, remat)
    for params in unstack_layers(stacked):
        x = body(x, params)
    return x


def dense_stack_prefill(stacked: dict, x: torch.Tensor, dims: BlockDims, *,
                        positions: torch.Tensor, causal: bool = True,
                        window: Optional[int] = None,
                        use_kernel: bool = True):
    """Full-sequence forward that also returns per-layer K/V for cache fill.
    Returns (x, ks, vs) with ks/vs: (L, B, S, Kv, hd)."""
    ks, vs = [], []
    for i in range(num_layers(stacked)):
        x, (k, v) = dense_block_apply(layer_params(stacked, i), x, dims,
                                      causal=causal, positions=positions,
                                      window=window, return_kv=True,
                                      use_kernel=use_kernel)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def cross_kv_from_encoder(p: dict, enc_out: torch.Tensor, dims: BlockDims):
    """A decoder layer's cross-attention K and V of the encoder output,
    each ``(B, S_enc, Kv, hd)``."""
    B, S, _ = enc_out.shape
    k = layers.matmul(enc_out, p["cross"]["wk"]).reshape(
        B, S, dims.n_kv_heads, dims.head_dim)
    v = layers.matmul(enc_out, p["cross"]["wv"]).reshape(
        B, S, dims.n_kv_heads, dims.head_dim)
    return k, v


def dense_block_decode(p: dict, x: torch.Tensor, cache_k, cache_v, index,
                       kv_positions, dims: BlockDims, *, window=None,
                       ring: bool = False, position=None, cross_cache=None,
                       decode_chunks=None, chunk_sharding=None,
                       kv_scales=None):
    """One-token decode.  Returns (x, cache_k, cache_v, kv_positions,
    kv_scales); the caches (and an int8 cache's scales) are written in
    place (see ``decode_attention_apply``).  ``cross_cache=(k, v)``: the
    encoder's K/V ``(B, S_enc, Kv, hd)`` for a block with a cross
    attention, read only."""
    h = norm(p["ln1"], x, dims.norm, dims.norm_eps)
    attn_out, nk, nv, npos, nsc = attn_lib.decode_attention_apply(
        p["attn"], h, cache_k, cache_v, index, n_heads=dims.n_heads,
        n_kv_heads=dims.n_kv_heads, head_dim=dims.head_dim,
        kv_positions=kv_positions, rope_theta=dims.rope_theta,
        position=position, window=window, ring=ring,
        decode_chunks=decode_chunks, chunk_sharding=chunk_sharding,
        kv_scales=kv_scales)
    x = x + attn_out
    if cross_cache is not None and "cross" in p:
        h = norm(p["ln_cross"], x, dims.norm, dims.norm_eps)
        c_out, _, _, _, _ = attn_lib.decode_attention_apply(
            p["cross"], h, cross_cache[0], cross_cache[1], index,
            n_heads=dims.n_heads, n_kv_heads=dims.n_kv_heads,
            head_dim=dims.head_dim, kv_positions=None, rope_theta=None,
            position=position, cross=True)
        x = x + c_out
    h = norm(p["ln2"], x, dims.norm, dims.norm_eps)
    return x + _mlp_apply(p["mlp"], h, dims.mlp), nk, nv, npos, nsc


def dense_stack_decode(stacked: dict, x: torch.Tensor, cache_k: torch.Tensor,
                       cache_v: torch.Tensor, index: torch.Tensor,
                       kv_positions: torch.Tensor, dims: BlockDims, *,
                       window: Optional[int] = None, ring: bool = False,
                       position: Optional[torch.Tensor] = None,
                       cross_caches=None,
                       decode_chunks: Optional[int] = None,
                       chunk_sharding=None, kv_scales=None):
    """cache_k/v: (L, B, S, Kv, hd), written in place; index: (B,);
    kv_positions: (B, S); cross_caches: the decoder's read-only
    ``(cross_k, cross_v)``, each (L, B, S_enc, Kv, hd), or None;
    kv_scales: (k_scale, v_scale), each (L, B, S, Kv, 1) f32, for an int8
    cache (written in place too).  Returns (x, cache_k, cache_v,
    kv_positions, kv_scales) — the new positions are the same for every
    layer, so layer 0's are kept, as in the JAX package."""
    npos = kv_positions
    for i in range(num_layers(stacked)):
        scales = None if kv_scales is None else (kv_scales[0][i],
                                                 kv_scales[1][i])
        cross = None if cross_caches is None else (cross_caches[0][i],
                                                   cross_caches[1][i])
        x, _, _, pos_i, _ = dense_block_decode(
            layer_params(stacked, i), x, cache_k[i], cache_v[i], index,
            kv_positions, dims, window=window, ring=ring, position=position,
            cross_cache=cross, decode_chunks=decode_chunks,
            chunk_sharding=chunk_sharding, kv_scales=scales)
        if i == 0:
            npos = pos_i
    return x, cache_k, cache_v, npos, kv_scales


# ---------------------------------------------------------------------------
# MoE block
# ---------------------------------------------------------------------------

def init_moe_block(gen: torch.Generator, dims: BlockDims, moe_cfg: MoEConfig,
                   *, lead: tuple = (), dtype=torch.float32) -> dict:
    return {
        "ln1": layers.init_rmsnorm(dims.d_model, lead=lead,
                                   device=gen.device, dtype=dtype),
        "attn": attn_lib.init_attention(
            gen, dims.d_model, dims.n_heads, dims.n_kv_heads, dims.head_dim,
            qk_norm=dims.qk_norm, lead=lead, dtype=dtype),
        "ln2": layers.init_rmsnorm(dims.d_model, lead=lead,
                                   device=gen.device, dtype=dtype),
        "moe": moe_lib.init_moe(gen, dims.d_model, dims.d_ff, moe_cfg,
                                lead=lead, dtype=dtype),
    }


def moe_block_apply(p: dict, x: torch.Tensor, dims: BlockDims,
                    moe_cfg: MoEConfig, *, positions=None,
                    window: Optional[int] = None, use_kernel: bool = True):
    """Full-sequence forward; returns (x, aux loss)."""
    h = layers.rmsnorm(p["ln1"], x, dims.norm_eps)
    attn_out, _ = attn_lib.attention_apply(
        p["attn"], h, n_heads=dims.n_heads, n_kv_heads=dims.n_kv_heads,
        head_dim=dims.head_dim, causal=True, positions=positions,
        rope_theta=dims.rope_theta, window=window, use_kernel=use_kernel)
    x = x + attn_out
    h = layers.rmsnorm(p["ln2"], x, dims.norm_eps)
    moe_out, aux = moe_lib.moe_apply(p["moe"], h, moe_cfg)
    return x + moe_out, aux


def moe_block_decode(p: dict, x: torch.Tensor, cache_k, cache_v, index,
                     kv_positions, dims: BlockDims, moe_cfg: MoEConfig, *,
                     window=None, ring: bool = False, position=None,
                     decode_chunks=None, chunk_sharding=None):
    """One-token decode; the caches are written in place.  The MoE runs
    on ``(B, 1, d)``: one group of B tokens, whose capacity is the
    reference's at that group size.  Returns (x, cache_k, cache_v,
    kv_positions)."""
    h = layers.rmsnorm(p["ln1"], x, dims.norm_eps)
    attn_out, nk, nv, npos, _ = attn_lib.decode_attention_apply(
        p["attn"], h, cache_k, cache_v, index, n_heads=dims.n_heads,
        n_kv_heads=dims.n_kv_heads, head_dim=dims.head_dim,
        kv_positions=kv_positions, rope_theta=dims.rope_theta,
        position=position, window=window, ring=ring,
        decode_chunks=decode_chunks, chunk_sharding=chunk_sharding)
    x = x + attn_out
    h = layers.rmsnorm(p["ln2"], x, dims.norm_eps)
    moe_out, _ = moe_lib.moe_apply(p["moe"], h, moe_cfg)
    return x + moe_out, nk, nv, npos


def moe_stack_apply(stacked: dict, x: torch.Tensor, dims: BlockDims,
                    moe_cfg: MoEConfig, *,
                    positions: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    use_kernel: bool = True, remat=False):
    """Full-sequence forward through L stacked MoE blocks; returns (x, the
    aux losses summed over the layers in f32).  Each layer is one
    ``remat`` unit, the aux carry inside it."""
    def body(h, aux, params):
        h, a = moe_block_apply(params, h, dims, moe_cfg, positions=positions,
                               window=window, use_kernel=use_kernel)
        return h, aux + a

    body = _maybe_checkpoint(body, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for params in unstack_layers(stacked):
        x, aux = body(x, aux, params)
    return x, aux


def moe_stack_decode(stacked: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, index: torch.Tensor,
                     kv_positions: torch.Tensor, dims: BlockDims,
                     moe_cfg: MoEConfig, *, window: Optional[int] = None,
                     ring: bool = False,
                     position: Optional[torch.Tensor] = None,
                     decode_chunks: Optional[int] = None,
                     chunk_sharding=None):
    """As :func:`dense_stack_decode` (no int8 scales): cache_k/v
    ``(L, B, S, Kv, hd)`` written in place.  Returns (x, cache_k, cache_v,
    kv_positions), layer 0's new positions."""
    npos = kv_positions
    for i in range(num_layers(stacked)):
        x, _, _, pos_i = moe_block_decode(
            layer_params(stacked, i), x, cache_k[i], cache_v[i], index,
            kv_positions, dims, moe_cfg, window=window, ring=ring,
            position=position, decode_chunks=decode_chunks,
            chunk_sharding=chunk_sharding)
        if i == 0:
            npos = pos_i
    return x, cache_k, cache_v, npos


# ---------------------------------------------------------------------------
# Mamba block (pre-norm residual wrapper around models/mamba.py)
# ---------------------------------------------------------------------------

def init_mamba_block(gen: torch.Generator, d_model: int, ssm_cfg: SSMConfig,
                     *, lead: tuple = (), dtype=torch.float32) -> dict:
    return {
        "ln": layers.init_rmsnorm(d_model, lead=lead, device=gen.device,
                                  dtype=dtype),
        "mamba": mamba.init_mamba(gen, d_model, ssm_cfg, lead=lead,
                                  dtype=dtype),
    }


def mamba_block_apply(p: dict, x: torch.Tensor, ssm_cfg: SSMConfig,
                      d_model: int, eps: float, *, use_kernel: bool = True):
    h = layers.rmsnorm(p["ln"], x, eps)
    out, state, conv_tail = mamba.mamba_apply(p["mamba"], h, ssm_cfg,
                                              d_model, use_kernel=use_kernel)
    return x + out, state, conv_tail


def mamba_block_decode(p: dict, x: torch.Tensor, ssm_state: torch.Tensor,
                       conv_state: torch.Tensor, ssm_cfg: SSMConfig,
                       d_model: int, eps: float):
    h = layers.rmsnorm(p["ln"], x, eps)
    out, ns, nc = mamba.mamba_decode_step(p["mamba"], h, ssm_state,
                                          conv_state, ssm_cfg, d_model)
    return x + out, ns, nc


def mamba_stack_apply(stacked: dict, x: torch.Tensor, ssm_cfg: SSMConfig,
                      d_model: int, eps: float, *,
                      use_kernel: bool = True, remat=False) -> torch.Tensor:
    """Full-sequence forward through L stacked Mamba blocks; each layer
    one ``remat`` unit."""
    def body(h, params):
        return mamba_block_apply(params, h, ssm_cfg, d_model, eps,
                                 use_kernel=use_kernel)[0]

    body = _maybe_checkpoint(body, remat)
    for params in unstack_layers(stacked):
        x = body(x, params)
    return x


def mamba_stack_decode(stacked: dict, x: torch.Tensor,
                       ssm_states: torch.Tensor, conv_states: torch.Tensor,
                       ssm_cfg: SSMConfig, d_model: int, eps: float):
    """ssm_states ``(L, B, H, P, N)`` and conv_states ``(L, B, W-1, ch)``
    are written in place, layer by layer (the JAX package returns new
    stacks; the values are the same).  Returns (x, ssm_states,
    conv_states)."""
    for i in range(num_layers(stacked)):
        x, ns, nc = mamba_block_decode(layer_params(stacked, i), x,
                                       ssm_states[i], conv_states[i],
                                       ssm_cfg, d_model, eps)
        ssm_states[i].copy_(ns)
        conv_states[i].copy_(nc)
    return x, ssm_states, conv_states


# ---------------------------------------------------------------------------
# hybrid (zamba2): super-blocks of N Mamba layers + one SHARED attn block
# ---------------------------------------------------------------------------

def hybrid_layout(n_layers: int, every: int) -> tuple[int, int]:
    """Returns (n_super_blocks, n_trailing_mamba_layers)."""
    return n_layers // every, n_layers % every


def hybrid_stack_apply(mamba_super: Optional[dict],
                       mamba_tail: Optional[dict], shared_attn: dict,
                       x: torch.Tensor, ssm_cfg: SSMConfig, dims: BlockDims,
                       *, positions: Optional[torch.Tensor] = None,
                       window: Optional[int] = None,
                       use_kernel: bool = True, remat=False) -> torch.Tensor:
    """mamba_super ``(n_super, every, ...)`` stacked, or None when there
    are fewer layers than ``every``; mamba_tail ``(n_tail, ...)`` or None;
    shared_attn one dense block, run after every super-block (with
    ``window``).  Under ``remat`` each super-block is one unit and each
    of its Mamba2 layers a unit nested in it; the tail's layers are units
    too."""
    def super_body(h, group):
        h = mamba_stack_apply(group, h, ssm_cfg, dims.d_model,
                              dims.norm_eps, use_kernel=use_kernel,
                              remat=remat)
        return dense_block_apply(shared_attn, h, dims, causal=True,
                                 positions=positions, window=window,
                                 use_kernel=use_kernel)

    super_body = _maybe_checkpoint(super_body, remat)
    if mamba_super is not None:
        for group in unstack_layers(mamba_super):
            x = super_body(x, group)
    if mamba_tail is not None:
        x = mamba_stack_apply(mamba_tail, x, ssm_cfg, dims.d_model,
                              dims.norm_eps, use_kernel=use_kernel,
                              remat=remat)
    return x


def hybrid_stack_decode(mamba_super, mamba_tail, shared_attn: dict,
                        x: torch.Tensor, ssm_super, conv_super, attn_k,
                        attn_v, ssm_tail, conv_tail, index: torch.Tensor,
                        kv_positions: torch.Tensor, ssm_cfg: SSMConfig,
                        dims: BlockDims, *, window: Optional[int] = None,
                        ring: bool = False,
                        position: Optional[torch.Tensor] = None):
    """ssm_super ``(n_super, every, B, H, P, N)``, conv_super ``(n_super,
    every, B, W-1, ch)``, attn_k/v ``(n_super, B, S, Kv, hd)``, the tail's
    ``(n_tail, ...)``: all written in place.  index ``(B,)`` and
    kv_positions ``(B, S)`` as in :func:`dense_stack_decode`.  Returns
    (x, ssm_super, conv_super, attn_k, attn_v, ssm_tail, conv_tail,
    kv_positions): the super-block caches are None without super-blocks,
    and then the positions come back unchanged, as in the JAX package."""
    npos = kv_positions
    for g in range(0 if mamba_super is None else num_layers(mamba_super)):
        x, _, _ = mamba_stack_decode(layer_params(mamba_super, g), x,
                                     ssm_super[g], conv_super[g], ssm_cfg,
                                     dims.d_model, dims.norm_eps)
        x, _, _, pos_g, _ = dense_block_decode(
            shared_attn, x, attn_k[g], attn_v[g], index, kv_positions, dims,
            window=window, ring=ring, position=position)
        if g == 0:  # the same for every block: block 0's are kept
            npos = pos_g
    if mamba_tail is not None:
        x, ssm_tail, conv_tail = mamba_stack_decode(
            mamba_tail, x, ssm_tail, conv_tail, ssm_cfg, dims.d_model,
            dims.norm_eps)
    return (x, ssm_super, conv_super, attn_k, attn_v, ssm_tail, conv_tail,
            npos)
