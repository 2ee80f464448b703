"""PyTorch port of the vertical-SplitNN system, for NVIDIA Hopper cards.

Mirrors the JAX package ``repro`` subpackage by subpackage and module by
module, so each function here has a counterpart of the same name there.
This package imports ``torch`` and numpy only: never ``jax``, never
``repro``.  Where it needs a contract of the JAX package (configs, compat
rules, byte models, op tables) it keeps its own copy.

Entry points (``init_params``, ``build_split_worker``, ``SplitLMServer``)
run on ``cuda`` unless the caller passes ``device="cpu"``; with no card and
no explicit ``"cpu"`` they raise (:func:`resolve_device`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the CPU only
    when asked for.  Raises when CUDA is wanted but absent — the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev


def tree_device(tree) -> Optional[torch.device]:
    """Device of the first tensor in a nested dict/list of tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else tree
    for item in items:
        if isinstance(item, (dict, list, tuple, torch.Tensor)):
            dev = tree_device(item)
            if dev is not None:
                return dev
    return None


__all__ = ["resolve_device", "tree_device"]
