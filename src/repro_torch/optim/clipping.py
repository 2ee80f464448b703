"""Global-norm gradient clipping."""
from __future__ import annotations

import torch

from repro_torch.tree_util import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / max(norm, 1e-12))``; returns
    (clipped grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    clipped = tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                       grads)
    return clipped, norm
