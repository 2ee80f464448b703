"""Architecture assembly for the dense and ssm families: params with the
vertical split or without it (the centralized baseline), the monolithic
forward, the decode caches, the dense prompt prefill (``prefill_tokens``)
and the decode step, the server trunk, the LM loss and the monolithic
training step, the parameter count, and the per-role split helpers.

Vertical split (``cfg.vertical``): the first ``tower_layers`` layers run as
K independent client towers over d_model/K feature slices; tower outputs
are merged (``cfg.vertical.merge``) at the cut layer; the remaining layers
form the server network.  With ``cfg.vertical`` None every layer is a
server layer and the tree has no ``towers``.  The tree has the JAX
package's layout, so weights carry across by a straight copy
(``repro_torch.interop``).

A compressed config (``cfg.vertical.compression``) runs its codec on the
stacked cuts before the merge, straight through, as the JAX package's
monolithic path does.  The other families (moe, hybrid, audio, vlm)
raise ``NotImplementedError`` naming the slice of the port that brings
them.
"""
from __future__ import annotations

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


def _check_family(cfg: ArchConfig) -> None:
    """The families the port runs so far; the rest raise by name."""
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family comes with a later slice "
            "of the port (it runs the dense and ssm families so far)")


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
    d_t = _tower_ssm_d(cfg) if cfg.family == "ssm" else \
        _tower_dims(cfg).d_model
    # draws in the order proj_in, blocks, proj_out
    proj_in = layers.dense_init(gen, cfg.d_model // K, d_t, lead=(K,),
                                dtype=dtype)
    if cfg.family == "ssm":
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
    """Seeded init of the dense or ssm family, with its vertical section
    or centralized, on ``device`` (``cuda`` unless ``"cpu"`` is asked
    for).  ``generator`` must live on that device; None means a fresh one
    seeded with 0.

    Shapes and scales are the JAX package's; the numbers are not (torch
    and jax draw differently from a seed) — tests that compare the two
    packages carry the JAX package's params across instead."""
    _check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params go to "
                         f"{dev}")
    return _init_tree(cfg, generator, dev, dtype)


def _init_tree(cfg: ArchConfig, generator, dev: torch.device, dtype) -> dict:
    n_server = _server_layers(cfg)
    # draws in the order embedding, server, towers
    embed = layers.init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                  dtype=dtype, tie=cfg.tie_embeddings)
    if cfg.family == "ssm":
        server = tfm.init_mamba_block(generator, cfg.d_model, cfg.ssm,
                                      lead=(n_server,), dtype=dtype)
    else:
        server = tfm.init_dense_block(generator, BlockDims.from_arch(cfg),
                                      lead=(n_server,), dtype=dtype)
    params = {
        "embed": embed,
        "final_norm": layers.init_rmsnorm(cfg.d_model, device=dev,
                                          dtype=dtype),
        "server": server,
    }
    if cfg.vertical is not None:
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
    _check_family(cfg)
    tree = _init_tree(cfg, _ShapeOnly(), torch.device("meta"), torch.float32)
    return sum(t.numel() for t in tree_leaves(tree))


# ---------------------------------------------------------------------------
# monolithic forward (prefill)
# ---------------------------------------------------------------------------

def _towers_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
                    positions: torch.Tensor, live_mask=None,
                    use_kernel: bool = True) -> torch.Tensor:
    """x ``(B, S, d_model)`` -> the merged cut activation: K towers over
    the feature slices, the codec, then ``merge_stacked`` with
    ``live_mask``, as the JAX package's monolithic path merges (no merge
    kernel here)."""
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
        if cfg.family == "ssm":
            h = tfm.mamba_stack_apply(blocks, h, cfg.ssm, h.shape[-1],
                                      cfg.norm_eps, use_kernel=use_kernel)
        else:
            h = tfm.dense_stack_apply(blocks, h, _tower_dims(cfg),
                                      causal=True, positions=positions,
                                      use_kernel=use_kernel)
        cuts.append(layers.matmul(h, w_out))
    return _merge_cuts(cuts, cfg, live_mask)


def forward(params: dict, batch: dict, cfg: ArchConfig, *, live_mask=None,
            use_kernel: bool = True):
    """Returns (logits ``(B, S, V)``, aux loss ``()``) for
    ``batch = {"tokens": (B, S)}``: embedding, the towers and their merge
    (with ``live_mask`` dropping clients; none when centralized), the
    server trunk, the final norm and the unembedding.
    ``use_kernel=False`` keeps every layer on the plain path (the model's
    ``ssd_chunked``; chunked attention past 2048
    tokens), on any device."""
    _check_family(cfg)
    dims = BlockDims.from_arch(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = layers.embed(params["embed"], tokens)
    positions = torch.arange(S, device=x.device)
    if cfg.vertical is not None:
        x = _towers_forward(params, x, cfg, positions=positions,
                            live_mask=live_mask, use_kernel=use_kernel)
    x = _server_trunk_apply(params, x, cfg, dims, positions=positions,
                            use_kernel=use_kernel)
    x = layers.rmsnorm(params["final_norm"], x, dims.norm_eps)
    return (layers.unembed(params["embed"], x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def make_prefill(cfg: ArchConfig, *, use_kernel: bool = True):
    """``prefill(params, batch) -> logits``: the forward, for serving a
    full prompt (the JAX package's ``make_prefill``)."""
    def prefill(params: dict, batch: dict) -> torch.Tensor:
        logits, _ = forward(params, batch, cfg, use_kernel=use_kernel)
        return logits

    return prefill


def _server_trunk_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                        dims: BlockDims, *, positions,
                        use_kernel: bool = True) -> torch.Tensor:
    """Post-merge server layers (the dense and ssm branches of the JAX
    package's ``_server_trunk_apply``; neither has an auxiliary loss)."""
    if cfg.family == "ssm":
        return tfm.mamba_stack_apply(params["server"], x, cfg.ssm,
                                     cfg.d_model, cfg.norm_eps,
                                     use_kernel=use_kernel)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the port's server trunk covers the dense and ssm "
            f"families only (got {cfg.family!r})")
    return tfm.dense_stack_apply(params["server"], x, dims, causal=True,
                                 positions=positions, use_kernel=use_kernel)


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
    - ssm: the server's ``ssm``/``conv`` stacks and the towers'.

    A centralized config (``cfg.vertical`` None) has no ``tower``.

    ``cache_len`` is the longest sequence, or the window of a ``ring``
    cache (which changes no shape: the ring is the decode step's slot
    arithmetic)."""
    _check_family(cfg)
    dev = resolve_device(device)
    v = cfg.vertical
    cache = {
        "index": torch.zeros((), dtype=torch.int32, device=dev),
        "kv_positions": torch.full((cache_len,), -1, dtype=torch.int32,
                                   device=dev),
    }
    if cfg.family == "ssm":
        cache.update(_ssm_cache(cfg, (_server_layers(cfg),), batch,
                                cfg.d_model, dtype, dev))
        if v is not None:
            cache["tower"] = _ssm_cache(cfg, (v.num_clients, v.tower_layers),
                                        batch, _tower_ssm_d(cfg), dtype, dev)
        return cache
    dims = BlockDims.from_arch(cfg)
    kv = (_server_layers(cfg), batch, cache_len, dims.n_kv_heads,
          dims.head_dim)
    kv_dtype = torch.int8 if kv_quant else dtype
    cache["k"] = torch.zeros(kv, dtype=kv_dtype, device=dev)
    cache["v"] = torch.zeros(kv, dtype=kv_dtype, device=dev)
    if kv_quant:
        cache["k_scale"] = torch.zeros(kv[:-1] + (1,), dtype=torch.float32,
                                       device=dev)
        cache["v_scale"] = torch.zeros(kv[:-1] + (1,), dtype=torch.float32,
                                       device=dev)
    if v is not None:
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
        if cfg.family == "ssm":
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
    The ssm family ignores the attention knobs, as the JAX package does."""
    _check_family(cfg)
    dims = BlockDims.from_arch(cfg)
    x = layers.embed(params["embed"], tokens[:, None])  # (B, 1, d)
    B = x.shape[0]
    new_cache = dict(cache)
    towers = cfg.vertical is not None
    if cfg.family == "ssm":
        if towers:
            x = _towers_decode(params, x, cache["tower"], None, None, cfg,
                               live_mask=live_mask)
        x, _, _ = tfm.mamba_stack_decode(params["server"], x, cache["ssm"],
                                         cache["conv"], cfg.ssm, cfg.d_model,
                                         cfg.norm_eps)
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
    x = layers.rmsnorm(params["final_norm"], x, dims.norm_eps)
    return layers.unembed(params["embed"], x)[:, 0, :], new_cache


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
    _check_family(cfg)
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
    ``jax.value_and_grad`` gives), then the optimizer's out-of-place
    update.  Eager: the JAX package jits this step."""
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
    """Per-client tower trees (each with its own copy of its embedding
    columns) and the role-0 server tree."""
    from repro_torch.models.split_program import get_program

    return get_program(cfg).partition(params)


def make_split_lm_fns(cfg: ArchConfig):
    """(tower_fwd, server_fwd, loss_fn) callables for the Executor."""
    from repro_torch.models.split_program import get_program

    program = get_program(cfg)
    return program.tower_fwd(0), program.server_fwd, program.loss_fn
