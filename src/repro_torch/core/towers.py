"""Client tower networks: the MLP towers of the paper's own setting
(tabular / embedded financial data).  The transformer towers of the token
LMs live in :mod:`repro_torch.models`."""
from __future__ import annotations

import torch

from repro_torch.models import layers


def init_mlp_tower(gen: torch.Generator, dims: list[int],
                   dtype=torch.float32) -> dict:
    """dims = [in, hidden..., out]; relu between, linear head.  The weights
    are drawn from ``gen`` in layer order and made on its device; the
    biases are zeros."""
    params = {f"w{i}": layers.dense_init(gen, dims[i], dims[i + 1],
                                         dtype=dtype)
              for i in range(len(dims) - 1)}
    params.update({f"b{i}": torch.zeros((dims[i + 1],), dtype=dtype,
                                        device=gen.device)
                   for i in range(len(dims) - 1)})
    return params


def mlp_tower_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """relu MLP; every product promotes its operands as ``jnp`` does, so
    f32 features through a bf16 tree give f32 activations."""
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = layers.matmul(x, params[f"w{i}"]) + params[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x
