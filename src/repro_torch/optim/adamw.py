"""AdamW, written out in PyTorch as the JAX package writes it
(``src/repro/optim/adamw.py``), not ``torch.optim.AdamW``.

Moments are f32 whatever the param dtype; the count is an int32 tensor;
bias terms are ``1 - b ** count``; ``eps`` is added after
``sqrt(v / c2)``; decoupled weight decay is added to the step before the
lr multiply; the schedule is evaluated at the incremented count.

The update writes the params, the moments and (when clipping) the
gradients in place, walking each leaf in flat slices
(:func:`~repro_torch.tree_util.flat_slices`), so that it holds the
params, the moments and the gradients, about 4x the param bytes of an
f32 tree, plus f32 temporaries of at most ``tree_util.SLICE`` elements.
``inplace=True`` hands it the trees given; ``inplace=False`` (the
default) hands it copies, and returns new trees.  The training loops
update in place; a split worker that keeps an earlier step's params for
a later backward clones them before the update lands (``TowerWorker``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

from repro_torch.optim.clipping import clip_by_global_norm_
from repro_torch.tree_util import flat_slices, tree_leaves, tree_map


@dataclass(frozen=True)
class AdamW:
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    inplace: bool = False

    def init(self, params) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        device = tree_leaves(params)[0].device
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=count.device)

    def update(self, params, grads, state: dict):
        """Returns (params, state).  With ``inplace`` these are the trees
        given, written in place (the gradients too, when clipped); without
        it the update runs on copies and leaves every tensor given as it
        was."""
        with torch.no_grad():
            if not self.inplace:
                params = tree_map(torch.clone, params)
                state = {**state, "mu": tree_map(torch.clone, state["mu"]),
                         "nu": tree_map(torch.clone, state["nu"])}
                if self.grad_clip_norm is not None:
                    grads = tree_map(torch.clone, grads)
            return self._update_(params, grads, state)

    def _update_(self, params, grads, state: dict):
        """The update, written into ``params``, the moments and (when
        clipping) ``grads``, leaf by leaf and slice by slice."""
        count = state["count"] + 1
        if self.grad_clip_norm is not None:
            clip_by_global_norm_(grads, self.grad_clip_norm)
        b1, b2 = self.b1, self.b2
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)
        lr = self._lr(count)
        for leaves in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["mu"]), tree_leaves(state["nu"])):
            for p, g, m, v in flat_slices(*leaves):
                g32 = g.to(torch.float32)
                m.mul_(b1).add_((1 - b1) * g32)
                v.mul_(b2).add_((1 - b2) * g32 * g32)
                del g32
                step = m / c1 / (torch.sqrt(v / c2) + self.eps)
                if self.weight_decay:
                    step = step + self.weight_decay * p.to(torch.float32)
                p.copy_(p.to(torch.float32) - lr * step)
        return params, {"mu": state["mu"], "nu": state["nu"], "count": count}
