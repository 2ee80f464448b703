"""Client-drop simulation (paper §4.3, Table 4, Figure 3).

The paper drops 1-3 of 4 clients uniformly at random, either per training
iteration ("drop during training") or on the test set ("drop during
testing").  A drop is realized as a live-mask handed to the merge — dropped
clients contribute their strategy's neutral element.

Masks are drawn from a ``torch.Generator`` on its own device, so a run on
the card draws them there without a host round trip.  torch cannot
reproduce ``jax.random``'s draws: tests that compare the two packages hand
the JAX package's masks across instead.
"""
from __future__ import annotations

import torch


def sample_live_mask(gen: torch.Generator, num_clients: int,
                     num_drop: int) -> torch.Tensor:
    """Uniformly drop exactly ``num_drop`` clients (those with the smallest
    of ``num_clients`` uniform scores).  Returns (K,) float32 0/1."""
    if num_drop <= 0:
        return torch.ones((num_clients,), dtype=torch.float32,
                          device=gen.device)
    if num_drop >= num_clients:
        raise ValueError("cannot drop every client")
    scores = torch.rand((num_clients,), generator=gen, device=gen.device)
    live = torch.ones((num_clients,), dtype=torch.float32, device=gen.device)
    # by rank, not by threshold: a tie in the scores still drops exactly
    # num_drop clients
    return live.index_fill(0, torch.argsort(scores)[:num_drop], 0.0)


def bernoulli_live_mask(gen: torch.Generator, num_clients: int,
                        drop_prob: float) -> torch.Tensor:
    """Independent per-client drop (straggler model); guarantees >= 1 live:
    if every client dropped, one chosen uniformly is resurrected."""
    live = torch.rand((num_clients,), generator=gen,
                      device=gen.device) < 1.0 - drop_prob
    # drawn every call, so the stream does not depend on the outcome
    fallback = torch.nn.functional.one_hot(
        torch.randint(0, num_clients, (), generator=gen, device=gen.device),
        num_clients).to(torch.bool)
    return torch.where(live.any(), live, fallback).to(torch.float32)
