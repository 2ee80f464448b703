"""Feature-holder builders.

The deployment-shaped contract: a client builds its OWN tower params (the
same seeded init as the driver) and its OWN feature source, so nothing but
protocol messages crosses the transport.  The params come from an
injectable source — the port's own seeded init, or a full param tree
handed in (for example the JAX package's weights carried across by
``repro_torch.interop``), since torch cannot reproduce ``jax.random``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import DeviceLike, resolve_device, tree_device
from repro_torch.transport.base import TowerWorker


def build_split_worker(client_id: int, *, cfg, seed: int = 0, batch: int = 8,
                       seq: int = 256, microbatches: int = 1,
                       learning_rate: Optional[float] = None,
                       warmup: int = 20, steps: int = 100,
                       grad_clip: float = 1.0, forward_delay_s: float = 0.0,
                       params: Optional[dict] = None,
                       device: DeviceLike = None,
                       use_kernel: bool = True) -> TowerWorker:
    """Feature holder for ``cfg``'s split program: trains (and serves) the
    client's tower.

    With ``params`` None, runs the seeded init (``torch.Generator`` seeded
    with ``seed`` on ``device``) and keeps only client ``client_id``'s
    tower partition — a copy; the rest of the init is dropped when this
    returns.  Otherwise partitions the given full param tree, which must
    already live on ``device``.  The worker regenerates its token stream
    from ``seed`` (``batch`` x ``seq`` per step, in ``microbatches``
    slices).  With ``learning_rate`` set, the tower trains locally under
    the same AdamW schedule as the server.  ``use_kernel=False`` keeps the
    serving prefill's long attention on the plain chunked path, as
    ``SplitLMServer(use_kernel=False)`` does at role 0 (comparison
    runs)."""
    from repro_torch.models import backbone, split_program
    from repro_torch.optim import AdamW
    from repro_torch.optim.schedules import linear_warmup_cosine

    dev = resolve_device(device)
    program = split_program.get_program(cfg)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = backbone.init_params(cfg, gen, device=dev)
    elif tree_device(params).type != dev.type:
        raise ValueError(f"params are on {tree_device(params)}, the worker "
                         f"runs on {dev}")
    tower = program.partition(params)[0][client_id]
    del params  # a seeded init is freed here; only the copied tower stays

    optimizer = None
    if learning_rate:
        optimizer = AdamW(
            learning_rate=linear_warmup_cosine(learning_rate, warmup, steps),
            weight_decay=0.1, grad_clip_norm=grad_clip)
    return TowerWorker(
        client_id, program.tower_fwd(client_id), tower,
        feature_fn=program.feature_fn(client_id, batch=batch, seq=seq,
                                      seed=seed, microbatches=microbatches,
                                      device=dev),
        optimizer=optimizer, forward_delay_s=forward_delay_s,
        compress=cfg.vertical.compression,
        serve_fns=program.tower_serve_fns(client_id, use_kernel=use_kernel),
        device=dev)
