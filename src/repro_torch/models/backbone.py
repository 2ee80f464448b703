"""Architecture assembly for every family (dense, moe, ssm, hybrid, audio,
vlm): params with the vertical split or without it (the centralized
baseline), the monolithic forward, the decode caches, the dense prompt
prefill (``prefill_tokens``), the modality prefills
(``prefill_cross_attention``, ``prefill_vision``) and the decode step,
the server trunk, the LM loss and the monolithic training step, the
parameter count, and the per-role split helpers.

Vertical split (``cfg.vertical``): the first ``tower_layers`` layers run as
K independent client towers over d_model/K feature slices; tower outputs
are merged (``cfg.vertical.merge``) at the cut layer; the remaining layers
form the server network.  With ``cfg.vertical`` None every layer is a
server layer and the tree has no ``towers``.  The tree has the JAX
package's layout, so weights carry across by a straight copy
(``repro_torch.interop``).

A compressed config (``cfg.vertical.compression``) runs its codec on the
stacked cuts before the merge, straight through, as the JAX package's
monolithic path does.  The hybrid (zamba2) server is super-blocks of
``shared_attn_every`` Mamba2 layers, each followed by ONE weight-shared
dense block, then the trailing Mamba2 layers; its towers are Mamba2
blocks of width d_model/K, as the ssm family's.  The moe server is its
first dense layers left after the towers (``server_dense``, FFN width
``d_ff * top_k``), then the MoE blocks, whose router aux loss the
forward returns; its towers stay dense (the experts live at role 0).

The audio family (whisper) is an encoder-decoder: the towers sit on the
encoder and split the frames' features (mel-band groups), the server
keeps the remaining ``encoder`` layers (None when the towers take them
all), ``enc_final_norm`` and the ``decoder``, whose blocks cross-attend
to the encoder's output.  Its blocks use LayerNorm, a GELU MLP and
sinusoidal positions added to the input (no RoPE).  The vlm family
(internvl) prepends vision patches to the text: its towers are the
modalities (``vision_tower`` non-causal over the patches, ``text_tower``
causal over the text at positions ``Sv + arange(S)``), merged by a
sequence concatenation, and the server unembeds the text positions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import compression as comp_lib
from repro_torch.core import merge as merge_lib
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import BlockDims
from repro_torch.tree_util import tree_leaves, tree_unflatten


def _tower_dims(cfg: ArchConfig) -> BlockDims:
    return BlockDims.from_arch(cfg).scaled(cfg.vertical.num_clients)


def _cut_dim(cfg: ArchConfig) -> int:
    v = cfg.vertical
    if v.merge == "concat":
        if cfg.d_model % v.num_clients:
            raise ValueError(f"{cfg.name}: concat needs d_model divisible by "
                             f"the {v.num_clients} clients")
        return cfg.d_model // v.num_clients
    return cfg.d_model


def _tower_ssm_d(cfg: ArchConfig) -> int:
    return cfg.d_model // cfg.vertical.num_clients


def _server_layers(cfg: ArchConfig) -> int:
    if cfg.vertical is None:
        return cfg.num_layers
    return cfg.num_layers - cfg.vertical.tower_layers


def _uses_feature_towers(cfg: ArchConfig) -> bool:
    """Feature-slice towers (the token-LM families and the audio encoder);
    the vlm family's towers are its modalities."""
    return cfg.vertical is not None and cfg.family != "vlm"


def params_dense_layers(cfg: ArchConfig) -> int:
    """The moe family's dense server layers: ``first_dense_layers`` less
    the tower layers (the towers come first and are dense anyway)."""
    if cfg.family != "moe":
        return 0
    n = cfg.moe.first_dense_layers
    if cfg.vertical is not None:
        n = max(0, n - cfg.vertical.tower_layers)
    return n


def _dense_layer_dims(cfg: ArchConfig) -> BlockDims:
    """The moe family's dense server layers: deepseek's dense layer has a
    wider FFN (``d_ff * top_k``, about the routed experts' width)."""
    dims = BlockDims.from_arch(cfg)
    return dataclasses.replace(dims, d_ff=cfg.d_ff * max(cfg.moe.top_k, 1))


def _ssm_towers(cfg: ArchConfig) -> bool:
    """The ssm and hybrid families' towers are Mamba2 blocks."""
    return cfg.family in ("ssm", "hybrid")


def _merge_cuts(cuts: list, cfg: ArchConfig, live_mask=None) -> torch.Tensor:
    """The monolithic path's cut layer: the config's codec on the (K, ...)
    stack (straight through), then the plain merge."""
    v = cfg.vertical
    stacked = comp_lib.apply_compression(torch.stack(cuts), v.compression,
                                         v.topk_fraction)
    return merge_lib.merge_stacked(stacked, v.merge, live_mask=live_mask)


def _init_towers(cfg: ArchConfig, gen: torch.Generator, dtype) -> dict:
    """Feature-slice towers, stacked over clients: (K, L_t, ...) params."""
    v = cfg.vertical
    K, Lt = v.num_clients, v.tower_layers
    d_t = _tower_ssm_d(cfg) if _ssm_towers(cfg) else _tower_dims(cfg).d_model
    # draws in the order proj_in, blocks, proj_out
    proj_in = layers.dense_init(gen, cfg.d_model // K, d_t, lead=(K,),
                                dtype=dtype)
    if _ssm_towers(cfg):
        blocks = tfm.init_mamba_block(gen, d_t, cfg.ssm, lead=(K, Lt),
                                      dtype=dtype)
    else:
        blocks = tfm.init_dense_block(gen, _tower_dims(cfg), lead=(K, Lt),
                                      dtype=dtype)
    return {
        "proj_in": proj_in,
        "blocks": blocks,
        "proj_out": layers.dense_init(gen, d_t, _cut_dim(cfg), lead=(K,),
                                      dtype=dtype),
    }


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device: DeviceLike = None, dtype=torch.float32) -> dict:
    """Seeded init of ``cfg``'s family, with its vertical section or
    centralized, on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for).  ``generator`` must live on that device; None means a fresh one
    seeded with 0.

    Shapes and scales are the JAX package's; the numbers are not (torch
    and jax draw differently from a seed) — tests that compare the two
    packages carry the JAX package's params across instead."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params go to "
                         f"{dev}")
    return _init_tree(cfg, generator, dev, dtype)


def _init_tree(cfg: ArchConfig, generator, dev: torch.device, dtype) -> dict:
    n_server = _server_layers(cfg)
    dims = BlockDims.from_arch(cfg)
    # draws in the order embedding, server, towers
    embed = layers.init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                  dtype=dtype, tie=cfg.tie_embeddings)
    params = {
        "embed": embed,
        "final_norm": tfm.init_norm(cfg.d_model, dims.norm, device=dev,
                                    dtype=dtype),
    }
    if cfg.family == "audio":
        enc_layers = cfg.encdec.encoder_layers
        if cfg.vertical is not None:
            enc_layers -= cfg.vertical.tower_layers
        params["encoder"] = tfm.init_dense_block(
            generator, dims, lead=(enc_layers,),
            dtype=dtype) if enc_layers else None
        params["enc_final_norm"] = tfm.init_norm(cfg.d_model, dims.norm,
                                                 device=dev, dtype=dtype)
        params["decoder"] = tfm.init_dense_block(
            generator, dims, lead=(cfg.num_layers,), dtype=dtype, cross=True)
    elif cfg.family == "ssm":
        params["server"] = tfm.init_mamba_block(
            generator, cfg.d_model, cfg.ssm, lead=(n_server,), dtype=dtype)
    elif cfg.family == "hybrid":
        # (n_super, every, ...) Mamba2 super-blocks and the (n_tail, ...)
        # trailing layers, each None when empty, as in the JAX package
        every = cfg.hybrid.shared_attn_every
        n_super, n_tail = tfm.hybrid_layout(n_server, every)
        params["server_super"] = tfm.init_mamba_block(
            generator, cfg.d_model, cfg.ssm, lead=(n_super, every),
            dtype=dtype) if n_super else None
        params["server_tail"] = tfm.init_mamba_block(
            generator, cfg.d_model, cfg.ssm, lead=(n_tail,),
            dtype=dtype) if n_tail else None
        params["shared_attn"] = tfm.init_dense_block(
            generator, BlockDims.from_arch(cfg), dtype=dtype)
    elif cfg.family == "moe":
        n_dense = params_dense_layers(cfg)
        if n_dense:
            params["server_dense"] = tfm.init_dense_block(
                generator, _dense_layer_dims(cfg), lead=(n_dense,),
                dtype=dtype)
        params["server"] = tfm.init_moe_block(
            generator, BlockDims.from_arch(cfg), cfg.moe,
            lead=(n_server - n_dense,), dtype=dtype)
    elif cfg.family in ("dense", "vlm"):
        params["server"] = tfm.init_dense_block(
            generator, dims, lead=(n_server,), dtype=dtype)
    else:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.family == "vlm" and cfg.vertical is not None:
        # the modality towers, one per client source, at full width
        Lt = cfg.vertical.tower_layers
        params["vision_tower"] = tfm.init_dense_block(
            generator, dims, lead=(Lt,), dtype=dtype)
        params["text_tower"] = tfm.init_dense_block(
            generator, dims, lead=(Lt,), dtype=dtype)
    elif cfg.vertical is not None:
        params["towers"] = _init_towers(cfg, generator, dtype)
    return params


class _ShapeOnly(torch.Generator):
    """A CPU generator whose tensors go to the ``meta`` device: the init
    runs for its shapes and allocates nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def param_count(cfg: ArchConfig) -> int:
    """Total parameter count, from shapes only (the init on the ``meta``
    device; nothing is allocated)."""
    tree = _init_tree(cfg, _ShapeOnly(), torch.device("meta"), torch.float32)
    return sum(t.numel() for t in tree_leaves(tree))


# ---------------------------------------------------------------------------
# monolithic forward (prefill)
# ---------------------------------------------------------------------------

def _towers_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
                    positions: torch.Tensor, live_mask=None,
                    causal: bool = True,
                    use_kernel: bool = True) -> torch.Tensor:
    """x ``(B, S, d_model)`` -> the merged cut activation: K towers over
    the feature slices (causal, or not: the audio encoder's), the codec,
    then ``merge_stacked`` with ``live_mask``, as the JAX package's
    monolithic path merges (no merge kernel here)."""
    v = cfg.vertical
    towers = params["towers"]
    # one unbind per stacked leaf: under autograd, indexing client by
    # client would sum K zero-filled whole-stack gradients
    per_client = zip(torch.unbind(towers["proj_in"]),
                     tfm.unstack_layers(towers["blocks"]),
                     torch.unbind(towers["proj_out"]))
    cuts = []
    for xk, (w_in, blocks, w_out) in zip(
            torch.chunk(x, v.num_clients, dim=-1), per_client):
        h = layers.matmul(xk, w_in)
        if _ssm_towers(cfg):
            h = tfm.mamba_stack_apply(blocks, h, cfg.ssm, h.shape[-1],
                                      cfg.norm_eps, use_kernel=use_kernel)
        else:
            h = tfm.dense_stack_apply(blocks, h, _tower_dims(cfg),
                                      causal=causal, positions=positions,
                                      use_kernel=use_kernel)
        cuts.append(layers.matmul(h, w_out))
    return _merge_cuts(cuts, cfg, live_mask)


def forward(params: dict, batch: dict, cfg: ArchConfig, *, live_mask=None,
            window: Optional[int] = None, use_kernel: bool = True):
    """Returns (logits, aux loss ``()``).

    ``batch``: ``{"tokens": (B, S)}``, plus ``"frames"`` ``(B, S_enc, d)``
    (audio) or ``"patches"`` ``(B, Sv, d)`` (vlm).  Token LMs: embedding,
    the towers and their merge (with ``live_mask`` dropping clients; none
    when centralized), the server trunk, the final norm and the
    unembedding, logits ``(B, S, V)``.  Audio: the encoder over the
    frames (towers over mel-band groups, non-causal), then the
    teacher-forced decoder over the tokens.  Vlm: the vision and text
    towers (``live_mask`` zeroes a dropped modality's segment), their
    sequence concatenation, the server over ``Sv + S`` positions, logits
    of the text positions ``(B, S, V)``.  ``window`` reaches the server's
    self-attention (not the audio family's, as in the JAX package).
    ``use_kernel=False`` keeps every layer on the plain path (the model's
    ``ssd_chunked``; chunked attention past 2048 tokens), on any device.
    The aux loss is the moe router's load-balance term summed over the
    layers, zero for the other families."""
    dims = BlockDims.from_arch(cfg)
    if cfg.family == "audio":
        enc_out = encode_audio(params, batch["frames"], cfg,
                               live_mask=live_mask, use_kernel=use_kernel)
        logits = _audio_decoder_apply(params, batch["tokens"], enc_out, cfg,
                                      dims, use_kernel=use_kernel)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=logits.device)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = layers.embed(params["embed"], tokens)
    if cfg.family == "vlm":
        return _forward_vlm(params, batch["patches"], x, cfg, dims,
                            live_mask=live_mask, window=window,
                            use_kernel=use_kernel)
    positions = torch.arange(S, device=x.device)
    if cfg.vertical is not None:
        x = _towers_forward(params, x, cfg, positions=positions,
                            live_mask=live_mask, use_kernel=use_kernel)
    x, aux = _server_trunk_apply(params, x, cfg, dims, positions=positions,
                                 window=window, use_kernel=use_kernel)
    x = layers.rmsnorm(params["final_norm"], x, dims.norm_eps)
    return layers.unembed(params["embed"], x), aux


def _forward_vlm(params: dict, patches: torch.Tensor, text: torch.Tensor,
                 cfg: ArchConfig, dims: BlockDims, *, live_mask, window,
                 use_kernel: bool):
    """The vlm forward from the embedded text ``(B, S, d)``."""
    patches = patches.to(params["embed"]["table"].dtype)
    Sv = patches.shape[1]
    full_pos = torch.arange(Sv + text.shape[1], device=text.device)
    if cfg.vertical is not None:
        vis = tfm.dense_stack_apply(params["vision_tower"], patches, dims,
                                    causal=False, positions=full_pos[:Sv],
                                    use_kernel=use_kernel)
        txt = tfm.dense_stack_apply(params["text_tower"], text, dims,
                                    causal=True, positions=full_pos[Sv:],
                                    use_kernel=use_kernel)
        if live_mask is not None:
            # modality drop: zero the dropped client's sequence segment
            # (f32 mask times bf16 segments is f32, as jnp promotes)
            live = torch.as_tensor(live_mask, device=vis.device)
            dtype = torch.promote_types(vis.dtype, live.dtype)
            vis = vis.to(dtype) * live[0]
            txt = txt.to(dtype) * live[1]
        x = torch.cat([vis, txt], dim=1)  # the sequence-concat merge
    else:
        x = torch.cat([patches, text], dim=1)
    x = tfm.dense_stack_apply(params["server"], x, dims, causal=True,
                              positions=full_pos, window=window,
                              use_kernel=use_kernel)
    x = layers.rmsnorm(params["final_norm"], x, dims.norm_eps)
    logits = layers.unembed(params["embed"], x[:, Sv:, :])
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def encode_audio(params: dict, frames: torch.Tensor, cfg: ArchConfig, *,
                 live_mask=None, use_kernel: bool = True) -> torch.Tensor:
    """The whisper encoder: frames ``(B, S_enc, d)`` (cast to the tree's
    dtype) plus the sinusoidal positions, the towers over the mel-band
    groups (non-causal) and their merge, the server's encoder layers and
    the final encoder norm -> ``(B, S_enc, d)``."""
    dims = BlockDims.from_arch(cfg)
    frames = frames.to(params["embed"]["table"].dtype)
    S_enc = frames.shape[1]
    h = frames + layers.sinusoidal_positions(
        S_enc, cfg.d_model, frames.dtype, device=frames.device)[None]
    if cfg.vertical is not None:
        h = _towers_forward(params, h, cfg,
                            positions=torch.arange(S_enc, device=h.device),
                            live_mask=live_mask, causal=False,
                            use_kernel=use_kernel)
    return _audio_encoder_tail(params, h, cfg, dims, use_kernel=use_kernel)


def _audio_encoder_tail(params: dict, h: torch.Tensor, cfg: ArchConfig,
                        dims: BlockDims, *,
                        use_kernel: bool = True) -> torch.Tensor:
    """Post-merge encoder layers and the final encoder norm.  Shared by
    the monolithic ``encode_audio`` and the split program's
    ``server_fwd`` (the merged cut enters here)."""
    if params["encoder"] is not None:
        h = tfm.dense_stack_apply(
            params["encoder"], h, dims, causal=False,
            positions=torch.arange(h.shape[1], device=h.device),
            use_kernel=use_kernel)
    return tfm.norm(params["enc_final_norm"], h, dims.norm, dims.norm_eps)


def _audio_decoder_apply(params: dict, tokens: torch.Tensor,
                         enc_out: torch.Tensor, cfg: ArchConfig,
                         dims: BlockDims, *,
                         use_kernel: bool = True) -> torch.Tensor:
    """The teacher-forced decoder over ``enc_out`` -> logits ``(B, S, V)``:
    embedding plus sinusoidal positions, each layer's self attention
    (causal) and cross attention over its own K/V of ``enc_out``, the
    final norm, the unembedding.  Shared by the monolithic forward and the
    split program's ``server_fwd``."""
    S = tokens.shape[1]
    x = layers.embed(params["embed"], tokens.long())
    x = x + layers.sinusoidal_positions(S, cfg.d_model, x.dtype,
                                        device=x.device)[None]
    dec_positions = torch.arange(S, device=x.device)
    enc_positions = torch.arange(enc_out.shape[1], device=x.device)
    for lp in tfm.unstack_layers(params["decoder"]):
        k, v = tfm.cross_kv_from_encoder(lp, enc_out, dims)
        x = tfm.dense_block_apply(lp, x, dims, causal=True,
                                  positions=dec_positions,
                                  cross_kv=(k, v, enc_positions),
                                  use_kernel=use_kernel)
    x = tfm.norm(params["final_norm"], x, dims.norm, dims.norm_eps)
    return layers.unembed(params["embed"], x)


def make_prefill(cfg: ArchConfig, *, use_kernel: bool = True):
    """``prefill(params, batch) -> logits``: the forward, for serving a
    full prompt (the JAX package's ``make_prefill``)."""
    def prefill(params: dict, batch: dict) -> torch.Tensor:
        logits, _ = forward(params, batch, cfg, use_kernel=use_kernel)
        return logits

    return prefill


def _server_trunk_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                        dims: BlockDims, *, positions,
                        window: Optional[int] = None,
                        use_kernel: bool = True):
    """Post-merge server layers of the token-LM families (the JAX
    package's ``_server_trunk_apply``); returns (x, aux), the aux loss
    ``()`` f32 being the moe router's, zero for the others.  ``window``
    reaches every self-attention (the ssm family has none).  Shared by
    the monolithic ``forward`` and the split program's ``server_fwd``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        x = tfm.mamba_stack_apply(params["server"], x, cfg.ssm, cfg.d_model,
                                  cfg.norm_eps, use_kernel=use_kernel)
    elif cfg.family == "hybrid":
        x = tfm.hybrid_stack_apply(
            params["server_super"], params["server_tail"],
            params["shared_attn"], x, cfg.ssm, dims, positions=positions,
            window=window, use_kernel=use_kernel)
    elif cfg.family == "moe":
        if "server_dense" in params:
            x = tfm.dense_stack_apply(params["server_dense"], x,
                                      _dense_layer_dims(cfg), causal=True,
                                      positions=positions, window=window,
                                      use_kernel=use_kernel)
        x, aux = tfm.moe_stack_apply(params["server"], x, dims, cfg.moe,
                                     positions=positions, window=window,
                                     use_kernel=use_kernel)
    elif cfg.family == "dense":
        x = tfm.dense_stack_apply(params["server"], x, dims, causal=True,
                                  positions=positions, window=window,
                                  use_kernel=use_kernel)
    else:
        raise ValueError(f"{cfg.name}: the server trunk is the token-LM "
                         f"families' (got {cfg.family!r})")
    return x, aux


# ---------------------------------------------------------------------------
# decode caches, prompt prefill and the decode step
# ---------------------------------------------------------------------------

def _ssm_cache(cfg: ArchConfig, lead: tuple, batch: int, d_model: int,
               dtype, device) -> dict:
    """Per-layer ssm state ``lead + (B, H, P, N)`` (f32) and conv ring
    ``lead + (B, W-1, ch)``."""
    ssm = cfg.ssm
    H = ssm.n_heads(d_model)
    P, N, W = ssm.head_dim, ssm.d_state, ssm.conv_width
    ch = ssm.d_inner(d_model) + 2 * ssm.n_groups * ssm.d_state
    return {
        "ssm": torch.zeros(lead + (batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros(lead + (batch, W - 1, ch), dtype=dtype,
                            device=device),
    }


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.float32, *, ring: bool = False,
               kv_quant: bool = False, device: DeviceLike = None) -> dict:
    """The decode cache, with the JAX package's keys, shapes and dtypes,
    on ``device`` (``cuda`` unless ``"cpu"`` is asked for): ``index``
    ``()`` int32 and ``kv_positions`` ``(cache_len,)`` int32 (-1 marks an
    unwritten slot), then per family

    - dense: the server's ``k``/``v`` ``(L, B, cache_len, Kv, hd)``
      (int8 with ``kv_quant``, plus ``k_scale``/``v_scale``
      ``(L, B, cache_len, Kv, 1)`` f32) and the towers' ``tower.k``/
      ``tower.v`` ``(K, Lt, B, cache_len, Kv_t, hd)``;
    - moe: the dense server layers' ``dense_k``/``dense_v`` when there
      are any, the MoE layers' ``k``/``v`` and the dense towers' (no int8:
      ``kv_quant`` is ignored, as in the JAX package);
    - ssm: the server's ``ssm``/``conv`` stacks and the towers';
    - hybrid: ``ssm_super``/``conv_super`` ``(n_super, every, B, ...)``
      and the shared block's ``attn_k``/``attn_v`` ``(n_super, B,
      cache_len, Kv, hd)`` when there are super-blocks, ``ssm_tail``/
      ``conv_tail`` ``(n_tail, B, ...)`` when there is a tail, and the
      ssm towers';
    - audio: the decoder's ``k``/``v`` ``(L, B, cache_len, Kv, hd)`` and
      its read-only cross-attention ``cross_k``/``cross_v`` ``(L, B,
      S_enc, Kv, hd)`` (filled by :func:`prefill_cross_attention`); the
      encoder's towers keep no cache;
    - vlm: the server's ``k``/``v`` (no int8: ``kv_quant`` is ignored, as
      in the JAX package), and with towers the text tower's
      ``text_tower_k``/``text_tower_v`` ``(Lt, B, cache_len, Kv, hd)``
      with its own ``text_tower_positions`` ``(cache_len,)`` (the text
      tower never attends over the vision prefix).

    A centralized config (``cfg.vertical`` None) has no ``tower``.

    ``cache_len`` is the longest sequence, or the window of a ``ring``
    cache (which changes no shape: the ring is the decode step's slot
    arithmetic)."""
    dev = resolve_device(device)
    v = cfg.vertical
    cache = {
        "index": torch.zeros((), dtype=torch.int32, device=dev),
        "kv_positions": torch.full((cache_len,), -1, dtype=torch.int32,
                                   device=dev),
    }
    if v is not None and _ssm_towers(cfg):
        cache["tower"] = _ssm_cache(cfg, (v.num_clients, v.tower_layers),
                                    batch, _tower_ssm_d(cfg), dtype, dev)
    if cfg.family == "ssm":
        cache.update(_ssm_cache(cfg, (_server_layers(cfg),), batch,
                                cfg.d_model, dtype, dev))
        return cache
    dims = BlockDims.from_arch(cfg)
    if cfg.family == "hybrid":
        every = cfg.hybrid.shared_attn_every
        n_super, n_tail = tfm.hybrid_layout(_server_layers(cfg), every)
        if n_super:
            sc = _ssm_cache(cfg, (n_super, every), batch, cfg.d_model, dtype,
                            dev)
            kv = (n_super, batch, cache_len, dims.n_kv_heads, dims.head_dim)
            cache.update(ssm_super=sc["ssm"], conv_super=sc["conv"],
                         attn_k=torch.zeros(kv, dtype=dtype, device=dev),
                         attn_v=torch.zeros(kv, dtype=dtype, device=dev))
        if n_tail:
            sc = _ssm_cache(cfg, (n_tail,), batch, cfg.d_model, dtype, dev)
            cache.update(ssm_tail=sc["ssm"], conv_tail=sc["conv"])
        return cache
    kv = (_server_layers(cfg), batch, cache_len, dims.n_kv_heads,
          dims.head_dim)
    if cfg.family == "audio":
        kv = (cfg.num_layers,) + kv[1:]
        cross = (cfg.num_layers, batch, cfg.encdec.encoder_seq_len,
                 dims.n_kv_heads, dims.head_dim)
        for key, shape in (("k", kv), ("v", kv), ("cross_k", cross),
                           ("cross_v", cross)):
            cache[key] = torch.zeros(shape, dtype=dtype, device=dev)
        return cache
    if cfg.family == "vlm":
        kv_quant = False
        if v is not None:
            tkv = (v.tower_layers,) + kv[1:]
            cache["text_tower_k"] = torch.zeros(tkv, dtype=dtype, device=dev)
            cache["text_tower_v"] = torch.zeros(tkv, dtype=dtype, device=dev)
            cache["text_tower_positions"] = torch.full(
                (cache_len,), -1, dtype=torch.int32, device=dev)
    if cfg.family == "moe":
        kv_quant = False
        n_dense = params_dense_layers(cfg)
        if n_dense:
            cache["dense_k"] = torch.zeros((n_dense,) + kv[1:], dtype=dtype,
                                           device=dev)
            cache["dense_v"] = torch.zeros((n_dense,) + kv[1:], dtype=dtype,
                                           device=dev)
        kv = (kv[0] - n_dense,) + kv[1:]
    kv_dtype = torch.int8 if kv_quant else dtype
    cache["k"] = torch.zeros(kv, dtype=kv_dtype, device=dev)
    cache["v"] = torch.zeros(kv, dtype=kv_dtype, device=dev)
    if kv_quant:
        cache["k_scale"] = torch.zeros(kv[:-1] + (1,), dtype=torch.float32,
                                       device=dev)
        cache["v_scale"] = torch.zeros(kv[:-1] + (1,), dtype=torch.float32,
                                       device=dev)
    if _uses_feature_towers(cfg):
        dims_t = _tower_dims(cfg)
        tkv = (v.num_clients, v.tower_layers, batch, cache_len,
               dims_t.n_kv_heads, dims_t.head_dim)
        cache["tower"] = {"k": torch.zeros(tkv, dtype=dtype, device=dev),
                          "v": torch.zeros(tkv, dtype=dtype, device=dev)}
    return cache


def _towers_decode(params: dict, x: torch.Tensor, tower_cache: dict,
                   index: torch.Tensor, kv_positions: torch.Tensor,
                   cfg: ArchConfig, *, window=None, ring: bool = False,
                   live_mask=None) -> torch.Tensor:
    """One-token tower pass, x ``(B, 1, d)``; the towers' caches are
    written in place.  Dense towers decode at the per-stream ``index``
    ``(B,)`` over ``kv_positions`` ``(B, S)`` with ``window``/``ring``
    and no chunks or scales, as in the JAX package (their new positions
    are the server's, which the caller keeps).  Returns the merged
    cut."""
    v = cfg.vertical
    towers = params["towers"]
    cuts = []
    for k, xk in enumerate(torch.chunk(x, v.num_clients, dim=-1)):
        h = layers.matmul(xk, towers["proj_in"][k])
        blocks = tfm.layer_params(towers["blocks"], k)
        if _ssm_towers(cfg):
            h, _, _ = tfm.mamba_stack_decode(
                blocks, h, tower_cache["ssm"][k], tower_cache["conv"][k],
                cfg.ssm, h.shape[-1], cfg.norm_eps)
        else:
            h, _, _, _, _ = tfm.dense_stack_decode(
                blocks, h, tower_cache["k"][k], tower_cache["v"][k], index,
                kv_positions, _tower_dims(cfg), window=window, ring=ring,
                position=index)
        cuts.append(layers.matmul(h, towers["proj_out"][k]))
    return _merge_cuts(cuts, cfg, live_mask)


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: ArchConfig, *, window: Optional[int] = None,
                ring: bool = False, live_mask=None,
                decode_chunks: Optional[int] = None, chunk_sharding=None):
    """One-token decode, tokens ``(B,)``.  Returns (logits ``(B, V)``,
    cache): the K/V rows (dense) or the ssm and conv states are written
    into the cache's tensors in place, ``index`` advances by one.

    Dense: the cache's scalar ``index`` and ``(S,)`` ``kv_positions`` are
    broadcast to the per-stream form of ``decode_attention_apply``;
    towers and server decode at ``position = index`` against the old
    positions, and the server's new ones are stored.  ``window``,
    ``ring`` and ``live_mask`` reach the towers and the server,
    ``decode_chunks`` and an int8 cache's scales the server only
    (``chunk_sharding``, an XLA sharding constraint, is refused there).
    The ssm family ignores the attention knobs, as the JAX package does;
    the hybrid family's shared attention blocks take ``window`` and
    ``ring`` (its towers and Mamba2 layers ignore them), and store their
    new positions when there is a super-block.  The moe family decodes
    its dense server layers with ``window`` and ``ring`` and its MoE
    layers with ``decode_chunks`` too; each MoE layer routes the B tokens
    as one group, at the reference's capacity for B tokens.  The audio
    family adds the sinusoidal position of ``index`` to the embedding and
    decodes its decoder with ``window`` and ``ring`` against the cache's
    cross-attention K/V (zeros until :func:`prefill_cross_attention`
    fills them); its towers (on the encoder) take no part.  The vlm
    family decodes the text tower over its own positions, then the
    server, both with ``window`` and ``ring`` (no ``live_mask`` nor
    chunks, as in the JAX package)."""
    dims = BlockDims.from_arch(cfg)
    x = layers.embed(params["embed"], tokens[:, None])  # (B, 1, d)
    B = x.shape[0]
    new_cache = dict(cache)
    towers = cfg.vertical is not None
    if cfg.family in ("audio", "vlm"):
        index = cache["index"].long().expand(B)
        kv_positions = cache["kv_positions"].expand(B, -1)
        stack, cross = params.get("server"), None
        if cfg.family == "audio":
            x = x + layers.sinusoidal_position_at(index, cfg.d_model,
                                                  x.dtype)[:, None, :]
            stack, cross = params["decoder"], (cache["cross_k"],
                                               cache["cross_v"])
        elif towers:
            # the text tower first, over its own slot positions
            x, _, _, tpos, _ = tfm.dense_stack_decode(
                params["text_tower"], x, cache["text_tower_k"],
                cache["text_tower_v"], index,
                cache["text_tower_positions"].expand(B, -1), dims,
                window=window, ring=ring, position=index)
            new_cache["text_tower_positions"] = tpos[0]
        x, _, _, npos, _ = tfm.dense_stack_decode(
            stack, x, cache["k"], cache["v"], index, kv_positions, dims,
            window=window, ring=ring, position=index, cross_caches=cross)
        new_cache["kv_positions"] = npos[0]
    elif cfg.family == "ssm":
        if towers:
            x = _towers_decode(params, x, cache["tower"], None, None, cfg,
                               live_mask=live_mask)
        x, _, _ = tfm.mamba_stack_decode(params["server"], x, cache["ssm"],
                                         cache["conv"], cfg.ssm, cfg.d_model,
                                         cfg.norm_eps)
    elif cfg.family == "hybrid":
        if towers:
            x = _towers_decode(params, x, cache["tower"], None, None, cfg,
                               live_mask=live_mask)
        index = cache["index"].long().expand(B)
        x, nss, _, _, _, _, _, npos = tfm.hybrid_stack_decode(
            params["server_super"], params["server_tail"],
            params["shared_attn"], x, cache.get("ssm_super"),
            cache.get("conv_super"), cache.get("attn_k"),
            cache.get("attn_v"), cache.get("ssm_tail"),
            cache.get("conv_tail"), index,
            cache["kv_positions"].expand(B, -1), cfg.ssm, dims,
            window=window, ring=ring, position=index)
        if nss is not None:
            new_cache["kv_positions"] = npos[0]
    elif cfg.family == "moe":
        index = cache["index"].long().expand(B)
        kv_positions = cache["kv_positions"].expand(B, -1)
        if towers:
            x = _towers_decode(params, x, cache["tower"], index,
                               kv_positions, cfg, window=window, ring=ring,
                               live_mask=live_mask)
        if "dense_k" in cache:
            x, _, _, _, _ = tfm.dense_stack_decode(
                params["server_dense"], x, cache["dense_k"],
                cache["dense_v"], index, kv_positions,
                _dense_layer_dims(cfg), window=window, ring=ring,
                position=index)
        x, _, _, npos = tfm.moe_stack_decode(
            params["server"], x, cache["k"], cache["v"], index, kv_positions,
            dims, cfg.moe, window=window, ring=ring, position=index,
            decode_chunks=decode_chunks, chunk_sharding=chunk_sharding)
        new_cache["kv_positions"] = npos[0]
    else:
        index = cache["index"].long().expand(B)
        kv_positions = cache["kv_positions"].expand(B, -1)
        if towers:
            x = _towers_decode(params, x, cache["tower"], index,
                               kv_positions, cfg, window=window, ring=ring,
                               live_mask=live_mask)
        kv_scales = None
        if "k_scale" in cache:
            kv_scales = (cache["k_scale"], cache["v_scale"])
        x, _, _, npos, _ = tfm.dense_stack_decode(
            params["server"], x, cache["k"], cache["v"], index, kv_positions,
            dims, window=window, ring=ring, position=index,
            decode_chunks=decode_chunks, chunk_sharding=chunk_sharding,
            kv_scales=kv_scales)
        new_cache["kv_positions"] = npos[0]
    new_cache["index"] = cache["index"] + 1
    x = tfm.norm(params["final_norm"], x, dims.norm, dims.norm_eps)
    return layers.unembed(params["embed"], x)[:, 0, :], new_cache


def prefill_cross_attention(params: dict, cache: dict, frames: torch.Tensor,
                            cfg: ArchConfig, *, live_mask=None,
                            use_kernel: bool = True) -> dict:
    """Whisper: encode the frames once (:func:`encode_audio`) and put every
    decoder layer's cross-attention K/V of the encoder output into the
    cache's ``cross_k``/``cross_v`` ``(L, B, S_enc, Kv, hd)``, in its
    dtype (new tensors, as the JAX package replaces them).  Returns the
    cache."""
    dims = BlockDims.from_arch(cfg)
    enc_out = encode_audio(params, frames, cfg, live_mask=live_mask,
                           use_kernel=use_kernel)
    B, S_enc, _ = enc_out.shape
    cross = params["decoder"]["cross"]
    L = cross["wk"].shape[0]
    new_cache = dict(cache)
    for key, w in (("cross_k", cross["wk"]), ("cross_v", cross["wv"])):
        kv = layers.einsum("bsd,ldh->lbsh", enc_out, w).reshape(
            L, B, S_enc, dims.n_kv_heads, dims.head_dim)
        new_cache[key] = kv.to(cache[key].dtype)
    return new_cache


def prefill_vision(params: dict, cache: dict, patches: torch.Tensor,
                   cfg: ArchConfig, *, use_kernel: bool = True) -> dict:
    """Vlm: the vision tower (non-causal) and the server over the vision
    prefix ``(B, Sv, d)``, filling the server's slots ``[0, Sv)`` of
    ``k``/``v`` and ``kv_positions`` in place; ``index`` becomes Sv.  The
    text tower's cache is left as it is (its slots below Sv stay
    unwritten).  Returns the cache."""
    dims = BlockDims.from_arch(cfg)
    x = patches.to(params["embed"]["table"].dtype)
    Sv = x.shape[1]
    positions = torch.arange(Sv, device=x.device)
    if cfg.vertical is not None:
        x = tfm.dense_stack_apply(params["vision_tower"], x, dims,
                                  causal=False, positions=positions,
                                  use_kernel=use_kernel)
    _, ks, vs = tfm.dense_stack_prefill(params["server"], x, dims,
                                        positions=positions, causal=True,
                                        use_kernel=use_kernel)
    cache["k"][:, :, :Sv] = ks.to(cache["k"].dtype)
    cache["v"][:, :, :Sv] = vs.to(cache["v"].dtype)
    cache["kv_positions"][:Sv] = positions.to(cache["kv_positions"].dtype)
    new_cache = dict(cache)
    new_cache["index"] = torch.full_like(cache["index"], Sv)
    return new_cache


def prefill_tokens(params: dict, cache: dict, tokens: torch.Tensor,
                   cfg: ArchConfig, *, use_kernel: bool = True):
    """Dense family: the teacher-forced pass over a prompt ``(B, S)`` that
    fills the cache (towers and the plain merge when vertical, the
    server).  Returns
    (logits of the last position ``(B, V)``, cache): slots ``[0, S)`` of
    the K/V tensors and ``kv_positions`` are written in place, ``index``
    becomes S.  The prompt is attended in full (no window), as in the
    JAX package.  Past 2048 tokens every attention runs the flash kernel
    on the card; ``use_kernel=False`` keeps it on the plain chunked path
    (comparison runs).

    Refused: other families (they replay the prompt through
    :func:`decode_step`), an int8 cache (the JAX package casts the K/V
    to int8 and leaves the scales at zero there, which no entry point of
    it reaches), and a prompt longer than the cache."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: prompt prefill is implemented for the dense "
            f"family; the {cfg.family!r} family replays the prompt through "
            "decode_step")
    if "k_scale" in cache:
        raise NotImplementedError(
            "prefill_tokens into an int8 (kv_quant) cache: the JAX package "
            "casts the prompt's K/V to int8 unscaled and leaves the scales "
            "at zero; the port does not copy that, and quantized prefill "
            "has no port yet")
    dims = BlockDims.from_arch(cfg)
    B, S = tokens.shape
    cache_len = cache["kv_positions"].shape[0]
    if S > cache_len:
        raise ValueError(
            f"a prompt of {S} tokens does not fit a cache of {cache_len} "
            "slots (a ring cache too: prefill writes the prompt whole); "
            "raise cache_len")
    positions = torch.arange(S, device=tokens.device)
    x = layers.embed(params["embed"], tokens)
    v = cfg.vertical
    if v is not None:
        towers, tcache = params["towers"], cache["tower"]
        cuts = []
        for k, xk in enumerate(torch.chunk(x, v.num_clients, dim=-1)):
            h = layers.matmul(xk, towers["proj_in"][k])
            h, ks, vs = tfm.dense_stack_prefill(
                tfm.layer_params(towers["blocks"], k), h, _tower_dims(cfg),
                positions=positions, use_kernel=use_kernel)
            tcache["k"][k, :, :, :S] = ks.to(tcache["k"].dtype)
            tcache["v"][k, :, :, :S] = vs.to(tcache["v"].dtype)
            cuts.append(layers.matmul(h, towers["proj_out"][k]))
        x = _merge_cuts(cuts, cfg)
    x, ks, vs = tfm.dense_stack_prefill(params["server"], x, dims,
                                        positions=positions,
                                        use_kernel=use_kernel)
    cache["k"][:, :, :S] = ks.to(cache["k"].dtype)
    cache["v"][:, :, :S] = vs.to(cache["v"].dtype)
    cache["kv_positions"][:S] = positions.to(cache["kv_positions"].dtype)
    new_cache = dict(cache)
    new_cache["index"] = torch.full_like(cache["index"], S)
    x = layers.rmsnorm(params["final_norm"], x, dims.norm_eps)
    return layers.unembed(params["embed"], x[:, -1, :]), new_cache


def make_serve_step(cfg: ArchConfig, *, window: Optional[int] = None,
                    ring: bool = False, decode_chunks: Optional[int] = None,
                    chunk_sharding=None):
    """``serve(params, cache, tokens) -> (logits, cache)``: the decode step
    with these knobs fixed (the JAX package's ``make_serve_step``)."""
    def serve(params: dict, cache: dict, tokens: torch.Tensor):
        return decode_step(params, cache, tokens, cfg, window=window,
                           ring=ring, decode_chunks=decode_chunks,
                           chunk_sharding=chunk_sharding)

    return serve


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; labels already shifted by the caller.
    f32 ``log_softmax``, then a gather at the label (int64 indices)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


def train_loss(params: dict, batch: dict, cfg: ArchConfig, *,
               live_mask=None, use_kernel: bool = True) -> torch.Tensor:
    """The LM loss of :func:`forward` on ``batch = {"tokens", "labels"}``
    plus its aux loss."""
    logits, aux = forward(params, batch, cfg, live_mask=live_mask,
                          use_kernel=use_kernel)
    return lm_loss(logits, batch["labels"]) + aux


def make_train_step(cfg: ArchConfig, optimizer, *, use_kernel: bool = True):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``: the
    loss and its gradient with respect to every leaf (a leaf the forward
    does not read, such as an untied input table's rows, gets zeros, as
    ``jax.value_and_grad`` gives), then the optimizer's update (in place
    with ``AdamW(inplace=True)``, as :func:`~repro_torch.train.loop.train`
    runs it: the returned params are then the tensors given).  Eager: the
    JAX package jits this step."""
    def step(params: dict, opt_state, batch: dict):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        with torch.enable_grad():
            loss = train_loss(tree_unflatten(params, leaves), batch, cfg,
                              use_kernel=use_kernel)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        params, opt_state = optimizer.update(
            params, tree_unflatten(params, grads), opt_state)
        return params, opt_state, loss.detach()

    return step


# ---------------------------------------------------------------------------
# split execution: per-role params + tower/server callables (thin wrappers
# over the token-LM SplitProgram, as in the JAX package)
# ---------------------------------------------------------------------------

def split_lm_params(cfg: ArchConfig, params: dict) -> tuple[list, dict]:
    """Per-client tower trees (copies, each with its columns of the
    embedding table) and the role-0 server tree (``params``' own
    tensors)."""
    from repro_torch.models.split_program import get_program

    return get_program(cfg).partition(params)


def make_split_lm_fns(cfg: ArchConfig):
    """(tower_fwd, server_fwd, loss_fn) callables for the Executor.  A
    program with per-client towers (audio, vlm) or an aux-loss slot (moe)
    needs the full SplitProgram interface, as in the JAX package."""
    from repro_torch.models.split_program import get_program

    program = get_program(cfg)
    if program.per_client_towers or program.has_aux:
        raise ValueError(
            f"{cfg.name} ({cfg.family}) needs the full SplitProgram "
            "interface (per-client towers / aux-loss slot); use "
            "repro_torch.models.split_program.get_program")
    return program.tower_fwd(0), program.server_fwd, program.loss_fn
