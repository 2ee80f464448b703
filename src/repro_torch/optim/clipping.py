"""Global-norm gradient clipping."""
from __future__ import annotations

import torch

from repro_torch.tree_util import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def _scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-12))``; returns
    (clipped grads, the norm before clipping).  Leaves ``grads`` as it
    was: :func:`clip_by_global_norm_` on a copy."""
    return clip_by_global_norm_(tree_map(torch.clone, grads), max_norm)


def clip_by_global_norm_(grads, max_norm: float):
    """Scale every leaf of ``grads`` in place by ``min(1, max_norm /
    max(norm, 1e-12))`` (a leaf of another dtype than f32 is scaled in f32
    and rounded back); returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = _scale(norm, max_norm)
    with torch.no_grad():
        for g in tree_leaves(grads):
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_(g.to(torch.float32) * scale)
    return grads, norm
