"""Architecture assembly: params for the dense family with its vertical
split, the server trunk, the LM loss and the per-role split helpers.

Vertical split (``cfg.vertical``): the first ``tower_layers`` layers run as
K independent client towers over d_model/K feature slices; tower outputs
are merged (``cfg.vertical.merge``) at the cut layer; the remaining layers
form the server network.  The tree has the JAX package's layout, so
weights carry across by a straight copy (``repro_torch.interop``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import BlockDims


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


def _server_layers(cfg: ArchConfig) -> int:
    if cfg.vertical is None:
        return cfg.num_layers
    return cfg.num_layers - cfg.vertical.tower_layers


def _init_towers(cfg: ArchConfig, gen: torch.Generator, dtype) -> dict:
    """Feature-slice towers, stacked over clients: (K, L_t, ...) params."""
    v = cfg.vertical
    K, Lt = v.num_clients, v.tower_layers
    dims_t = _tower_dims(cfg)
    return {
        "proj_in": layers.dense_init(gen, cfg.d_model // K, dims_t.d_model,
                                     lead=(K,), dtype=dtype),
        "blocks": tfm.init_dense_block(gen, dims_t, lead=(K, Lt),
                                       dtype=dtype),
        "proj_out": layers.dense_init(gen, dims_t.d_model, _cut_dim(cfg),
                                      lead=(K,), dtype=dtype),
    }


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, device: DeviceLike = None, dtype=torch.float32) -> dict:
    """Seeded init of the dense family with a vertical section, on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for).  ``generator``
    must live on that device; None means a fresh one seeded with 0.

    Shapes and scales are the JAX package's; the numbers are not (torch
    and jax draw differently from a seed) — tests that compare the two
    packages carry the JAX package's params across instead."""
    if cfg.family != "dense" or cfg.vertical is None:
        raise NotImplementedError(
            f"{cfg.name}: the port initializes the dense family with a "
            "vertical section so far")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, params go to "
                         f"{dev}")
    dims = BlockDims.from_arch(cfg)
    return {
        "embed": layers.init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                       dtype=dtype, tie=cfg.tie_embeddings),
        "final_norm": layers.init_rmsnorm(cfg.d_model, device=dev,
                                          dtype=dtype),
        "server": tfm.init_dense_block(generator, dims,
                                       lead=(_server_layers(cfg),),
                                       dtype=dtype),
        "towers": _init_towers(cfg, generator, dtype),
    }


def _server_trunk_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
                        dims: BlockDims, *, positions) -> torch.Tensor:
    """Post-merge server layers (the dense branch of the JAX package's
    ``_server_trunk_apply``; the family has no auxiliary loss)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the port's server trunk covers the dense family "
            f"only (got {cfg.family!r})")
    return tfm.dense_stack_apply(params["server"], x, dims, causal=True,
                                 positions=positions)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy; labels already shifted by the caller.
    f32 ``log_softmax``, then a gather at the label (int64 indices)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


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
