"""Protocol core: merge strategies, compat rules, byte models, schedule,
and the Compact Bilinear Pooling merge (``bilinear``)."""
from repro_torch.core import bilinear  # noqa: F401
