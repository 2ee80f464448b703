"""Optimizers, written out in PyTorch (no ``torch.optim``): the JAX
package's ``repro.optim`` arithmetic, update for update."""
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.sgd import SGD

__all__ = ["AdamW", "SGD"]
