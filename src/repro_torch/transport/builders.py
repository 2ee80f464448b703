"""Feature-holder builders.

The deployment-shaped contract: a client builds its OWN tower params, so
nothing but protocol messages crosses the transport.  The params come
from an injectable source — the port's own seeded init, or a full param
tree handed in (for example the JAX package's weights carried across by
``repro_torch.interop``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import DeviceLike, resolve_device, tree_device
from repro_torch.transport.base import TowerWorker


def build_split_worker(client_id: int, *, cfg, seed: int = 0,
                       params: Optional[dict] = None,
                       device: DeviceLike = None) -> TowerWorker:
    """Serving feature holder for ``cfg``'s split program.

    With ``params`` None, runs the seeded init (``torch.Generator`` seeded
    with ``seed`` on ``device``) and keeps only client ``client_id``'s
    tower partition; otherwise partitions the given full param tree, which
    must already live on ``device``."""
    from repro_torch.models import backbone, split_program

    dev = resolve_device(device)
    program = split_program.get_program(cfg)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = backbone.init_params(cfg, gen, device=dev)
    elif tree_device(params).type != dev.type:
        raise ValueError(f"params are on {tree_device(params)}, the worker "
                         f"runs on {dev}")
    towers, _ = program.partition(params)
    return TowerWorker(client_id, towers[client_id],
                       serve_fns=program.tower_serve_fns(client_id),
                       compress=cfg.vertical.compression, device=dev)
