"""SGD with (Nesterov) momentum, written out in PyTorch as the JAX package
writes it (``src/repro/optim/sgd.py``): the light optimizer of the MLP
studies.

The velocity is f32 whatever the param dtype; the count is an int32
tensor and the schedule is evaluated at the incremented count.  Updates
are out of place, as :class:`~repro_torch.optim.AdamW`'s are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

from repro_torch.tree_util import tree_leaves, tree_map


@dataclass(frozen=True)
class SGD:
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-2
    momentum: float = 0.0
    nesterov: bool = False
    grad_clip_norm: Optional[float] = None

    def init(self, params) -> dict:
        device = tree_leaves(params)[0].device
        count = torch.zeros((), dtype=torch.int32, device=device)
        if self.momentum == 0.0:
            return {"count": count}
        return {"velocity": tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params),
                "count": count}

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
        lr = self._lr(count)
        if self.momentum == 0.0:
            new_params = tree_map(
                lambda p, g: (p.to(torch.float32)
                              - lr * g.to(torch.float32)).to(p.dtype),
                params, grads)
            return new_params, {"count": count}

        vel = tree_map(lambda v, g: self.momentum * v + g.to(torch.float32),
                       state["velocity"], grads)

        def upd_p(p, v, g):
            step = (self.momentum * v + g.to(torch.float32) if self.nesterov
                    else v)
            return (p.to(torch.float32) - lr * step).to(p.dtype)

        new_params = tree_map(upd_p, params, vel, grads)
        return new_params, {"velocity": vel, "count": count}
