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
from repro_torch.tree_util import tree_map


def _sgd(learning_rate: float):
    """Dependency-free local optimizer for MLP workers: ``p - lr * g``, out
    of place (the worker keeps the params each step's forwards ran
    under)."""

    class _SGD:
        def init(self, params):
            return None

        def update(self, params, grads, state):
            return tree_map(lambda p, g: p - learning_rate * g, params,
                            grads), state

    return _SGD()


def build_mlp_worker(client_id: int, *, cfg, param_seed: int = 0,
                     data_seed: int = 0, batch: int = 16,
                     microbatches: int = 1,
                     learning_rate: Optional[float] = None,
                     forward_delay_s: float = 0.0,
                     compress: Optional[str] = None,
                     topk_fraction: float = 0.25,
                     params: Optional[dict] = None,
                     features=None,
                     device: DeviceLike = None) -> TowerWorker:
    """Paper-MLP feature holder: keeps only its own tower of the shared
    seeded init and serves its own feature columns of a per-step stream.

    ``params`` None runs :func:`~repro_torch.core.split_model.init_split_mlp`
    from a generator seeded with ``param_seed`` on ``device``; otherwise
    ``params`` is the full ``{"towers", "server"}`` tree (for example the
    JAX package's, carried across by ``repro_torch.interop``), already on
    ``device``.  ``features(step) -> (batch, input_dim)`` is the full
    feature matrix of ``step``, of which the worker serves microbatch
    ``mb``'s rows and its client's columns; a ``(steps, batch,
    input_dim)`` tensor is such a table (picklable, so a spawned worker
    can be handed one); None means the stream
    ``x_step ~ N(0, 1)`` drawn from a generator seeded with ``data_seed +
    step``.  With ``learning_rate`` set the tower trains locally under
    plain SGD.  ``compress`` ("topk" | "int8") compresses the worker's cut
    uplinks at the source with error feedback."""
    from repro_torch.core import split_model, towers

    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(param_seed)
        params = split_model.init_split_mlp(gen, cfg, device=dev)
    elif tree_device(params).type != dev.type:
        raise ValueError(f"params are on {tree_device(params)}, the worker "
                         f"runs on {dev}")
    tower = params["towers"][client_id]
    columns = split_model.feature_slices(cfg)[client_id]
    mbsz = batch // microbatches

    if isinstance(features, torch.Tensor):
        features = features.__getitem__
    elif features is None:
        def features(step: int) -> torch.Tensor:
            gen = torch.Generator(device=dev).manual_seed(data_seed + step)
            return torch.randn((batch, cfg.input_dim), generator=gen,
                               device=dev)

    def feature_fn(step: int, mb: int) -> torch.Tensor:
        x = features(step)[mb * mbsz:(mb + 1) * mbsz]
        return split_model.client_columns(x, columns)

    return TowerWorker(
        client_id, towers.mlp_tower_apply, tower, feature_fn=feature_fn,
        optimizer=_sgd(learning_rate) if learning_rate else None,
        forward_delay_s=forward_delay_s, compress=compress,
        topk_fraction=topk_fraction, device=dev)


def build_split_worker(client_id: int, *, cfg, seed: int = 0, batch: int = 8,
                       seq: int = 256, microbatches: int = 1,
                       learning_rate: Optional[float] = None,
                       warmup: int = 20, steps: int = 100,
                       grad_clip: float = 1.0, forward_delay_s: float = 0.0,
                       params: Optional[dict] = None,
                       device: DeviceLike = None,
                       use_kernel: bool = True) -> TowerWorker:
    """Feature holder for ``cfg``'s split program: trains the client's
    tower and, for the dense family, serves it.

    With ``params`` None, runs the seeded init (``torch.Generator`` seeded
    with ``seed`` on ``device``) and keeps a copy of client ``client_id``'s
    tower only; the rest of the init is dropped when this returns.
    Otherwise the tower is client ``client_id``'s part of the given full
    param tree, which must already live on ``device``: a copy when the
    worker trains (it updates its tower in place, and shares no tensor
    with role 0), views into the tree when it only serves.  The worker regenerates its feature stream from ``seed``
    (``batch`` x ``seq`` per step, in ``microbatches`` slices): token
    LMs the shared tokens, audio its mel-band slice of the frames, vlm
    its modality (the patches or the tokens).  With ``learning_rate``
    set, the tower trains locally, in place, under the same AdamW
    schedule as the server.  ``cfg.vertical.compression``
    (and its ``topk_fraction``) makes the worker compress its cut uplinks
    at the source, with error feedback.  ``use_kernel=False`` keeps the
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
        tower = program.tower_params(
            backbone.init_params(cfg, gen, device=dev), client_id)
    elif tree_device(params).type != dev.type:
        raise ValueError(f"params are on {tree_device(params)}, the worker "
                         f"runs on {dev}")
    else:
        tower = program.tower_params(params, client_id)

    if params is None or learning_rate:
        # storage of its own: a training tower is updated in place, and a
        # seeded tower leaves the rest of the init to be freed
        tower = tree_map(torch.clone, tower)
    optimizer = None
    if learning_rate:
        optimizer = AdamW(
            learning_rate=linear_warmup_cosine(learning_rate, warmup, steps),
            weight_decay=0.1, grad_clip_norm=grad_clip, inplace=True)
    # a family without a serving decomposition (ssm, hybrid) gets a worker that
    # trains and refuses serving ops by name, as in the JAX package
    try:
        serve_fns = program.tower_serve_fns(client_id, use_kernel=use_kernel)
    except NotImplementedError:
        serve_fns = None
    return TowerWorker(
        client_id, program.tower_fwd(client_id), tower,
        feature_fn=program.feature_fn(client_id, batch=batch, seq=seq,
                                      seed=seed, microbatches=microbatches,
                                      device=dev),
        optimizer=optimizer, forward_delay_s=forward_delay_s,
        compress=cfg.vertical.compression,
        topk_fraction=cfg.vertical.topk_fraction,
        serve_fns=serve_fns,
        device=dev)
