"""AdamW, written out in PyTorch as the JAX package writes it
(``src/repro/optim/adamw.py``), not ``torch.optim.AdamW``.

Moments are f32 whatever the param dtype; the count is an int32 tensor;
bias terms are ``1 - b ** count``; ``eps`` is added after
``sqrt(v / c2)``; decoupled weight decay is added to the step before the
lr multiply; the schedule is evaluated at the incremented count.

Updates are out of place: ``update`` returns new param tensors and never
writes the ones it was given.  A split worker keeps the params each
step's forwards ran under (``TowerWorker._step_params``) while a later
step's update lands, and an in-place update would change that snapshot.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

from repro_torch.tree_util import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamW:
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None

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
        """Returns (new params, new state); nothing is written in place."""
        count = state["count"] + 1
        if self.grad_clip_norm is not None:
            from repro_torch.optim.clipping import clip_by_global_norm

            grads, _ = clip_by_global_norm(grads, self.grad_clip_norm)
        b1, b2 = self.b1, self.b2

        def upd_mu(m, g):
            return b1 * m + (1 - b1) * g.to(torch.float32)

        def upd_nu(v, g):
            g32 = g.to(torch.float32)
            return b2 * v + (1 - b2) * g32 * g32

        mu = tree_map(upd_mu, state["mu"], grads)
        nu = tree_map(upd_nu, state["nu"], grads)
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)
        lr = self._lr(count)

        def upd_param(p, m, v):
            step = m / c1 / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                step = step + self.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr * step).to(p.dtype)

        new_params = tree_map(upd_param, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu, "count": count}
