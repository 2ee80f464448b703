"""Sampling for serving."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    greedy: bool = False


def sample_token(logits: torch.Tensor, sp: SamplingParams,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits (..., V) -> token ids (...).  Greedy takes the first maximum
    (``torch.argmax``, like ``jnp.argmax``); sampling draws from
    ``generator``, which must live on the logits' device."""
    if sp.greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / max(sp.temperature, 1e-6)
    if sp.top_k:
        kth = torch.topk(logits, sp.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        probs.shape[:-1])
