"""VerticalSplitMLP — the paper's experimental model, end to end.

K client towers over vertical feature slices + merge + server MLP, with
client dropping and (beyond the paper) cut compression, straight-through
(:mod:`repro_torch.core.compression`).  The transformer-scale version
lives in :mod:`repro_torch.models`; this one drives the paper's
experiments (Tables 2-4).

The merge is the plain :func:`repro_torch.core.merge.merge_stacked`, as
the JAX package's one-program step merges: that step reaches no kernel.
The deployment-shaped path — :func:`repro_torch.transport.build_mlp_worker`
feeding an :class:`~repro_torch.runtime.executor.Executor` — merges
through the merge kernels.

The train steps are eager PyTorch: ``torch.autograd.grad`` over the param
leaves, then the optimizer's out-of-place update.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.vertical_mlp import MLPSplitConfig
from repro_torch.core import compression as comp_lib
from repro_torch.core import merge as merge_lib
from repro_torch.core import partition as part_lib
from repro_torch.core import towers
from repro_torch.core.dropping import sample_live_mask
from repro_torch.tree_util import tree_leaves, tree_unflatten


def feature_slices(cfg: MLPSplitConfig) -> list[part_lib.FeatureSlice]:
    slices = part_lib.by_source_partition(cfg.client_feature_sizes)
    part_lib.validate_partition(slices, cfg.input_dim)
    return slices


def client_columns(x: torch.Tensor, s: part_lib.FeatureSlice) -> torch.Tensor:
    """Client ``s``'s columns of ``x (B, input_dim)``.  A by-source slice is
    a contiguous range, so this is a view: no index tensor, no gather and
    no host-to-device copy per call.  Any other slice is refused."""
    lo, hi = s.indices[0], s.indices[-1] + 1
    if s.indices != tuple(range(lo, hi)):
        raise ValueError(f"client {s.client}'s slice is not a contiguous "
                         "range of columns")
    return x[:, lo:hi]


def _generator(gen: Optional[torch.Generator],
               device: DeviceLike) -> torch.Generator:
    dev = resolve_device(device)
    if gen is None:
        return torch.Generator(device=dev).manual_seed(0)
    if gen.device.type != dev.type:
        raise ValueError(f"generator is on {gen.device}, params go to {dev}")
    return gen


def init_split_mlp(gen: Optional[torch.Generator], cfg: MLPSplitConfig,
                   dtype=torch.float32, *, device: DeviceLike = None) -> dict:
    """Seeded init on ``device`` (``cuda`` unless ``"cpu"`` is asked for):
    ``{"towers": [K tower dicts], "server": dict}``, drawn from ``gen``
    (which must live on that device; None means a fresh one seeded with
    0) in the order tower 0 .. K-1, server.  Shapes and scales are the JAX
    package's; the numbers are not (torch and jax draw differently)."""
    gen = _generator(gen, device)
    tower_params = [
        towers.init_mlp_tower(
            gen, [cfg.client_feature_sizes[k], *cfg.tower_hidden,
                  cfg.cut_dim], dtype)
        for k in range(cfg.num_clients)
    ]
    server_in = merge_lib.merged_dim(cfg.merge, cfg.cut_dim, cfg.num_clients)
    server_params = towers.init_mlp_tower(
        gen, [server_in, *cfg.server_hidden, cfg.num_classes], dtype)
    return {"towers": tower_params, "server": server_params}


def init_centralized_mlp(gen: Optional[torch.Generator], cfg: MLPSplitConfig,
                         dtype=torch.float32, *,
                         device: DeviceLike = None) -> dict:
    """The paper's 'Single Model' baseline: same depth/width, full
    features."""
    gen = _generator(gen, device)
    return towers.init_mlp_tower(
        gen, [cfg.input_dim, *cfg.tower_hidden, cfg.cut_dim,
              *cfg.server_hidden, cfg.num_classes], dtype)


def centralized_forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    return towers.mlp_tower_apply(params, x)


def split_forward(params: dict, x: torch.Tensor, cfg: MLPSplitConfig, *,
                  live_mask: Optional[torch.Tensor] = None,
                  compression: Optional[str] = None,
                  topk_fraction: float = 0.25) -> torch.Tensor:
    """``x (B, input_dim)``, the full feature matrix: each tower reads its
    client's columns (its cut compressed by ``compression``, straight
    through), the plain merge joins the (K, B, cut_dim) stack, the server
    maps it to logits."""
    stacked = torch.stack([
        comp_lib.apply_compression(
            towers.mlp_tower_apply(params["towers"][k], client_columns(x, s)),
            compression, topk_fraction)
        for k, s in enumerate(feature_slices(cfg))])
    merged = merge_lib.merge_stacked(stacked, cfg.merge, live_mask=live_mask)
    return towers.mlp_tower_apply(params["server"], merged)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 num_classes: int) -> torch.Tensor:
    """Mean cross-entropy, written out as the JAX package writes it:
    ``log_softmax`` of the f32 logits against a one-hot."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).to(
        torch.float32)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def _value_and_grad(loss_fn, params, *args):
    """The loss and its gradient tree over ``params`` (fresh leaves, so the
    graph starts at the params)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), *args)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_split_train_step(cfg: MLPSplitConfig, optimizer, *,
                          num_drop: int = 0,
                          compression: Optional[str] = None):
    """Returns ``step(params, opt_state, gen, x, y, *, live_mask=None) ->
    (params, opt_state, loss)``.

    With ``num_drop`` > 0 each step drops that many clients: the live mask
    is drawn from ``gen`` (the JAX step's key), unless ``live_mask`` (K,)
    is handed in — tests inject the JAX package's masks that way.  The
    loss comes back as a 0-d tensor on the params' device.  ``compression``
    runs the codec on every cut at the JAX step's fraction, 0.25."""

    def loss_fn(params, x, y, live):
        logits = split_forward(params, x, cfg, live_mask=live,
                               compression=compression, topk_fraction=0.25)
        return softmax_xent(logits, y, cfg.num_classes)

    def step(params, opt_state, gen: Optional[torch.Generator], x, y, *,
             live_mask: Optional[torch.Tensor] = None):
        if live_mask is None and num_drop > 0:
            if gen is None:
                raise ValueError(f"num_drop={num_drop}: the step needs a "
                                 "generator or a live_mask")
            live_mask = sample_live_mask(gen, cfg.num_clients, num_drop)
        loss, grads = _value_and_grad(loss_fn, params, x, y, live_mask)
        params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    return step


def make_centralized_train_step(cfg: MLPSplitConfig, optimizer):
    """Returns ``step(params, opt_state, x, y) -> (params, opt_state,
    loss)``."""

    def loss_fn(params, x, y):
        return softmax_xent(centralized_forward(params, x), y,
                            cfg.num_classes)

    def step(params, opt_state, x, y):
        loss, grads = _value_and_grad(loss_fn, params, x, y)
        params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, loss

    return step
