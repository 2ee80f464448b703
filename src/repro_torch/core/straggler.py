"""Straggler mitigation via cut-activation imputation (the paper's §4.3
client-drop setting carried over to stragglers).

The role-0 server keeps an exponential moving average of each client's
cut activation (averaged over every non-feature axis); when a client is
missing from a merge, its seat is filled with that EMA instead of the
merge's neutral element.  No extra client communication is needed: the
state lives where the activations already arrive.

:func:`impute_stack` is the bookkeeping without the merge, so the
Executor's no-wait path feeds the filled stack to the merge kernels
(``runtime.executor.fast_merge``).  It runs inside the graph that the
server backward differentiates: a filled seat gets zero gradient, a live
seat the merge's own backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.vertical_mlp import MLPSplitConfig
from repro_torch.core import merge as merge_lib
from repro_torch.core import split_model, towers
from repro_torch.core.dropping import sample_live_mask
from repro_torch.tree_util import tree_leaves, tree_unflatten


def init_ema_state(cfg: MLPSplitConfig, dtype=torch.float32, *,
                   device: DeviceLike = None) -> dict:
    """(K, cut_dim) per-client EMA of batch-mean cut activations, on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for)."""
    dev = resolve_device(device)
    return {
        "ema": torch.zeros((cfg.num_clients, cfg.cut_dim), dtype=dtype,
                           device=dev),
        "initialized": torch.zeros((cfg.num_clients,), dtype=torch.float32,
                                   device=dev),
    }


def impute_stack(cuts: torch.Tensor, live_mask: torch.Tensor,
                 ema_state: dict, *, decay: float = 0.95):
    """Returns (imputed_cuts, new_ema_state).

    ``cuts`` is ``(K, ..., D)`` with any middle dims — (K, B, D) for the
    paper MLP, (K, B, S, D) for transformer towers — and ``live_mask``
    ``(K,)``; a dropped row may hold anything.  Live clients update their
    EMA with their mean over every non-feature axis; dropped clients are
    REPLACED by their EMA, broadcast over those axes, so the merge sees
    every seat filled.  Dtypes promote as ``jnp.where`` promotes them."""
    K, D = cuts.shape[0], cuts.shape[-1]
    lv = live_mask.reshape((K,) + (1,) * (cuts.ndim - 1))
    batch_mean = torch.mean(cuts.reshape(K, -1, D), dim=1)  # (K, D)

    ema = ema_state["ema"]
    init = ema_state["initialized"].reshape(K, 1)
    new_ema = torch.where(
        live_mask.reshape(K, 1) > 0,
        torch.where(init > 0, decay * ema + (1 - decay) * batch_mean,
                    batch_mean),
        ema)
    new_init = torch.maximum(ema_state["initialized"], live_mask)

    ema_full = new_ema.reshape((K,) + (1,) * (cuts.ndim - 2) + (D,)).expand(
        cuts.shape)
    imputed = torch.where(lv > 0, cuts, ema_full)
    return imputed, {"ema": new_ema, "initialized": new_init}


def impute_and_merge(cuts: torch.Tensor, live_mask: torch.Tensor,
                     ema_state: dict, merge: str, *, decay: float = 0.95):
    """Returns (merged, new_ema_state); see :func:`impute_stack`.  Merges
    with the plain version, as the JAX package's one-program step does."""
    imputed, new_state = impute_stack(cuts, live_mask, ema_state, decay=decay)
    return merge_lib.merge_stacked(imputed, merge), new_state


def detach_state(ema_state: dict) -> dict:
    """The EMA state without autograd history: a step that keeps the
    graph would chain onto every earlier step's."""
    return {k: v.detach() for k, v in ema_state.items()}


def make_imputing_train_step(cfg: MLPSplitConfig, optimizer, *,
                             num_drop: int, decay: float = 0.95):
    """Split training step with EMA imputation of dropped clients.

    Returns ``step(params, opt_state, ema_state, gen, x, y, *,
    live_mask=None) -> (params, opt_state, ema_state, loss)``.  Each step
    drops ``num_drop`` clients with a mask drawn from ``gen`` (a
    ``torch.Generator``, the JAX step's key) through
    ``dropping.sample_live_mask``, unless ``live_mask`` (K,) is handed in
    — tests inject the JAX package's masks that way.  The returned EMA
    state is detached."""
    slices = split_model.feature_slices(cfg)

    def loss_fn(params, ema_state, live, x, y):
        cuts = torch.stack([
            towers.mlp_tower_apply(params["towers"][k],
                                   split_model.client_columns(x, s))
            for k, s in enumerate(slices)])
        merged, new_ema = impute_and_merge(cuts, live, ema_state, cfg.merge,
                                           decay=decay)
        logits = towers.mlp_tower_apply(params["server"], merged)
        return (split_model.softmax_xent(logits, y, cfg.num_classes),
                new_ema)

    def step(params, opt_state, ema_state: dict,
             gen: Optional[torch.Generator], x, y, *,
             live_mask: Optional[torch.Tensor] = None):
        if live_mask is None:
            if gen is None:
                if num_drop > 0:
                    raise ValueError(f"num_drop={num_drop}: the step needs "
                                     "a generator or a live_mask")
                live_mask = torch.ones((cfg.num_clients,),
                                       dtype=torch.float32, device=x.device)
            else:
                live_mask = sample_live_mask(gen, cfg.num_clients, num_drop)
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        with torch.enable_grad():
            loss, new_ema = loss_fn(tree_unflatten(params, leaves),
                                    ema_state, live_mask, x, y)
        grads = tree_unflatten(params, list(torch.autograd.grad(loss,
                                                                leaves)))
        params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, detach_state(new_ema), loss.detach()

    return step
