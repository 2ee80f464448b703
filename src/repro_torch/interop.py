"""Carry weights and arrays across from the JAX package, as numpy arrays.

``params_from_numpy`` turns a param tree of numpy arrays (the JAX
package's tree after ``np.asarray`` on every leaf) into the port's tensors
on ``device``.  The layout is kept as it is — stacked ``(L, ...)`` layers,
``(K, ...)`` towers, a hybrid's ``(n_super, every, ...)`` super-blocks —
so the copy is straight; a ``None`` subtree (a hybrid without super-blocks
or without a tail, a whisper tree whose towers take every encoder layer)
stays ``None``, and each leaf keeps its own dtype (a moe router stays f32
in a bf16 tree).  Every family's tree carries across this way: the audio
family's LayerNorm ``scale`` / ``bias``, GELU biases and ``cross``
subtrees and the vlm family's untied ``unembed`` and modality towers are
leaves and dicts like any other.  bfloat16 arrays (numpy's
``ml_dtypes`` extension type, which ``torch.from_numpy`` rejects) go
through float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


def tensor_from_numpy(array, device: DeviceLike = None) -> torch.Tensor:
    # a copy: the source may be a read-only view of a JAX buffer, and the
    # port writes some tensors (KV caches) in place
    a = np.array(array, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=resolve_device(device), dtype=torch.bfloat16)
    return torch.from_numpy(a).to(resolve_device(device))


def params_from_numpy(tree, device: DeviceLike = None):
    """Nested dict/list/tuple of arrays -> the same nesting of tensors."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def to_numpy(tree):
    """The reverse: tensors -> numpy arrays (bfloat16 as float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree
