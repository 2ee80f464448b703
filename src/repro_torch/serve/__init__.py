"""Serving: sampling and split inference serving over a transport of tower
workers, with continuous batching."""
from repro_torch.serve.decode import SamplingParams, sample_token
from repro_torch.serve.split_serve import (CutCache, ServeRequest,
                                           ServeResult, SplitLMServer)

__all__ = [
    "SamplingParams",
    "sample_token",
    "CutCache",
    "ServeRequest",
    "ServeResult",
    "SplitLMServer",
]
