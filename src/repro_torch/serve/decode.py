"""Serving without a split: sampling, and autoregressive generation of the
ssm family (the prompt replayed through the decode step)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import tree_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import backbone


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


def generate(params: dict, cfg: ArchConfig, prompts, *,
             max_new_tokens: int = 32, cache_len: Optional[int] = None,
             sampling: SamplingParams = SamplingParams(greedy=True),
             seed: int = 0) -> torch.Tensor:
    """Returns the generated tokens ``(B, max_new_tokens)``, on the device
    of ``params`` (``cuda`` unless they were made on the CPU).

    prompts ``(B, S_prompt)`` integer tokens (a tensor or an array).  The
    ssm family replays the prompt through :func:`backbone.decode_step`, one
    token at a time, as the JAX package's ``generate`` does for every
    family but dense; greedy decoding gives the JAX package's tokens.
    The dense family's fused prompt prefill (``prefill_tokens``) comes with
    a later slice of the port and raises here.  Sampling draws from a
    generator seeded with ``seed`` on the params' device."""
    if cfg.family == "dense":
        raise NotImplementedError(
            f"{cfg.name}: monolithic generation of the dense family needs "
            "prefill_tokens, which comes with a later slice of the port "
            "(split serving of the dense family is SplitLMServer)")
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family comes with a later slice "
            "of the port")
    device = tree_device(params)
    prompts = torch.as_tensor(prompts, device=device).long()
    B, S_prompt = prompts.shape
    if cache_len is None:
        cache_len = S_prompt + max_new_tokens
    elif S_prompt + max_new_tokens > cache_len:
        raise ValueError(
            f"cache_len={cache_len} cannot hold {S_prompt} prompt + "
            f"{max_new_tokens} new tokens = {S_prompt + max_new_tokens} "
            "positions — raise cache_len")
    cache = backbone.init_cache(cfg, B, cache_len, device=device)
    gen = None if sampling.greedy else torch.Generator(
        device=device).manual_seed(seed)
    logits = None
    for t in range(S_prompt):
        logits, cache = backbone.decode_step(params, cache, prompts[:, t],
                                             cfg)
    out = []
    for i in range(max_new_tokens):
        tok = sample_token(logits, sampling, gen)
        out.append(tok)
        if i + 1 < max_new_tokens:  # the last token needs no decode step
            logits, cache = backbone.decode_step(params, cache, tok, cfg)
    return torch.stack(out, dim=1)
