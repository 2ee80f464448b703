"""Optimizers, written out in PyTorch (no ``torch.optim``): the JAX
package's ``repro.optim`` arithmetic, update for update."""
from repro_torch.optim.adamw import AdamW

__all__ = ["AdamW"]
