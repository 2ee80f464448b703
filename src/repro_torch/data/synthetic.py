"""Synthetic stand-ins for the paper's three financial datasets.

The real Bank Marketing / Give Me Some Credit / Financial PhraseBank corpora
are not available offline; we generate class-conditional Gaussian-mixture
datasets matched in (a) sample count, (b) dimensionality, (c) class count
and imbalance, and (d) vertical-partition structure.  Crucially, signal is
spread over *every* feature group so each vertical client carries partial
predictive power — without that the paper's client-drop study (Table 4)
would be degenerate.

Claims validated against these are qualitative (orderings, parities,
degradation patterns).

The data are drawn with numpy alone, as the JAX package's
``data/synthetic.py`` draws them, and equal its arrays bit for bit.  :func:`to_device` moves a whole split to the
card once, and :func:`minibatches` then indexes it there with the same
permutations it draws for numpy arrays, so a run on the card copies no
batch from the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.vertical_mlp import MLPSplitConfig, PAPER_DATASETS


@dataclass
class Dataset:
    """The splits as numpy arrays, or as tensors after :func:`to_device`."""

    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def num_features(self) -> int:
        return self.x_train.shape[1]

    @property
    def num_classes(self) -> int:
        return int(self.y_train.max()) + 1


# (num_samples, class_priors) matched to the paper's Table 1 datasets
_SPECS = {
    # Bank Marketing: 45k x 16, 2 classes, ~11.7% positive
    "bank_marketing": (45000, (0.883, 0.117)),
    # Give Me Some Credit: 30k x 25, 2 classes, ~6.7% positive
    "give_me_credit": (30000, (0.933, 0.067)),
    # Financial PhraseBank: ~5k x 300 GloVe dims, 3 classes 59/28/13
    "financial_phrasebank": (4845, (0.59, 0.28, 0.13)),
}


def make_dataset(
    name: str,
    seed: int = 0,
    test_fraction: float = 0.2,
    class_sep: float = 1.1,
    label_noise: float = 0.05,
) -> Dataset:
    """Class-conditional Gaussian mixture with per-group signal."""
    cfg: MLPSplitConfig = PAPER_DATASETS[name]
    n, priors = _SPECS[name]
    d, c = cfg.input_dim, cfg.num_classes
    rng = np.random.default_rng(seed)

    y = rng.choice(c, size=n, p=np.asarray(priors))
    # class means: drawn once, then scaled so every feature group carries
    # signal (each vertical slice gets its own independent mean component)
    means = rng.normal(0.0, class_sep / np.sqrt(d), size=(c, d))
    # per-class anisotropic noise for realism
    scales = rng.uniform(0.8, 1.2, size=(c, d))
    x = means[y] + rng.normal(size=(n, d)) * scales[y]
    # label noise: the paper's tasks are far from separable (bank F1 ~ 0.47)
    flip = rng.random(n) < label_noise
    y[flip] = rng.choice(c, size=int(flip.sum()))

    x = (x - x.mean(0)) / (x.std(0) + 1e-8)
    n_test = int(n * test_fraction)
    perm = rng.permutation(n)
    x, y = x[perm].astype(np.float32), y[perm].astype(np.int32)
    return Dataset(
        name=name,
        x_train=x[n_test:],
        y_train=y[n_test:],
        x_test=x[:n_test],
        y_test=y[:n_test],
    )


def to_device(ds: Dataset, device: DeviceLike = None) -> Dataset:
    """The same dataset with every split as a tensor on ``device`` (``cuda``
    unless ``"cpu"`` is asked for), copied once."""
    dev = resolve_device(device)

    def move(a):
        return torch.from_numpy(a).to(dev)

    return Dataset(name=ds.name, x_train=move(ds.x_train),
                   y_train=move(ds.y_train), x_test=move(ds.x_test),
                   y_test=move(ds.y_test))


def minibatches(x, y, batch_size: int, seed: int, epochs: int = 1):
    """Shuffled minibatch iterator (drops the ragged tail).  ``x`` and ``y``
    are numpy arrays or tensors; for tensors each epoch's permutation (the
    same numpy draw) goes to their device once and the batches are
    gathered there."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    for _ in range(epochs):
        perm = rng.permutation(n)
        if isinstance(x, torch.Tensor):
            perm = torch.from_numpy(perm).to(x.device)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i:i + batch_size]
            yield x[idx], y[idx]
