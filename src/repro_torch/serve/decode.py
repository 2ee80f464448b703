"""Serving without a split: sampling, autoregressive generation (the dense
family's fused prompt prefill, the other families' prompt replayed
through the decode step) and the decode-throughput probe."""
from __future__ import annotations

import statistics
import time
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
             seed: int = 0, window: Optional[int] = None,
             ring: bool = False) -> torch.Tensor:
    """Returns the generated tokens ``(B, max_new_tokens)``, on the device
    of ``params`` (``cuda`` unless they were made on the CPU).

    prompts ``(B, S_prompt)`` integer tokens (a tensor or an array).  The
    dense family fills the cache with :func:`backbone.prefill_tokens`
    (the prompt attended in full); the other families replay the prompt
    through :func:`backbone.decode_step`, one token at a time, as the JAX
    package does (a moe decode step routes the B streams' tokens as one
    group, at the reference's capacity for B tokens: a stream's tokens
    depend on its batch, as there).  The audio and vlm families decode
    without their modality, as the JAX package's ``generate`` does: it
    never calls ``prefill_cross_attention`` or ``prefill_vision``, so
    audio attends to zero cross caches and vlm has no vision prefix (the
    path that serves a modality is ``init_cache``, the modality prefill,
    then ``decode_step``).  Decoding runs with ``window`` and, where ``ring``
    is set, over a ring cache of ``cache_len`` slots, which wraps by
    design; a linear cache that cannot hold the prompt and the new
    tokens is refused.  Greedy decoding gives the JAX package's tokens;
    sampling draws from a generator seeded with ``seed`` on the params'
    device."""
    device = tree_device(params)
    prompts = torch.as_tensor(prompts, device=device).long()
    B, S_prompt = prompts.shape
    if cache_len is None:
        cache_len = S_prompt + max_new_tokens
    elif not ring and S_prompt + max_new_tokens > cache_len:
        # a linear cache that is too small would clamp writes into its
        # last slot
        raise ValueError(
            f"cache_len={cache_len} cannot hold {S_prompt} prompt + "
            f"{max_new_tokens} new tokens = {S_prompt + max_new_tokens} "
            "positions — raise cache_len (or pass ring=True for "
            "sliding-window decode)")
    cache = backbone.init_cache(cfg, B, cache_len, ring=ring, device=device)
    step = backbone.make_serve_step(cfg, window=window, ring=ring)
    gen = None if sampling.greedy else torch.Generator(
        device=device).manual_seed(seed)
    if cfg.family == "dense":
        logits, cache = backbone.prefill_tokens(params, cache, prompts, cfg)
    else:
        for t in range(S_prompt):
            logits, cache = step(params, cache, prompts[:, t])
    out = []
    for i in range(max_new_tokens):
        tok = sample_token(logits, sampling, gen)
        out.append(tok)
        if i + 1 < max_new_tokens:  # the last token needs no decode step
            logits, cache = step(params, cache, tok)
    return torch.stack(out, dim=1)


def batched_throughput_probe(params: dict, cfg: ArchConfig, *, batch: int,
                             cache_len: int, steps: int = 8,
                             warmup: int = 2, window: Optional[int] = None,
                             ring: bool = False) -> dict:
    """Decode throughput of ``batch`` streams over a cache of
    ``cache_len`` slots, on the device of ``params``: the same knobs as
    :func:`generate`, so the probe measures the configuration served, and
    the MEDIAN of the per-step times after ``warmup`` steps.  On the card
    each timed step lies between two ``torch.cuda.synchronize()``
    calls."""
    device = tree_device(params)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    cache = backbone.init_cache(cfg, batch, cache_len, ring=ring,
                                device=device)
    step = backbone.make_serve_step(cfg, window=window, ring=ring)
    tok = torch.zeros((batch,), dtype=torch.long, device=device)
    for _ in range(max(1, warmup)):
        _, cache = step(params, cache, tok)
    times = []
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        _, cache = step(params, cache, tok)
        sync()
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    return {
        "tokens_per_s": batch / dt,
        "ms_per_step": dt * 1e3,
        "batch": batch,
        "steps": steps,
        "window": window,
        "ring": ring,
    }
