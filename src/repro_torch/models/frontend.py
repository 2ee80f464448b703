"""Modality frontend stubs: the port's copy of the JAX package's.

Audio (whisper): the mel-spectrogram + conv feature extractor is stubbed —
callers supply precomputed frame embeddings ``(B, n_frames, d_model)``.
Vision (internvl): the InternViT encoder + MLP projector are stubbed —
callers supply precomputed patch embeddings ``(B, n_patches, d_model)``.

For smoke runs the embeddings are drawn with the statistics a real
frontend would give (a standard normal times 0.5), from a
``torch.Generator`` (on its device): the numbers differ from the JAX
package's ``jax.random`` draws, the shapes and scales do not.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig


def synth_audio_frames(gen: torch.Generator, batch: int, cfg: ArchConfig,
                       dtype=torch.float32) -> torch.Tensor:
    n = cfg.encdec.encoder_seq_len
    return (torch.randn((batch, n, cfg.d_model), generator=gen,
                        device=gen.device) * 0.5).to(dtype)


def synth_vision_patches(gen: torch.Generator, batch: int, cfg: ArchConfig,
                         dtype=torch.float32) -> torch.Tensor:
    n = cfg.vlm.num_vision_tokens
    return (torch.randn((batch, n, cfg.d_model), generator=gen,
                        device=gen.device) * 0.5).to(dtype)


def audio_frames_spec(batch: int, cfg: ArchConfig) -> tuple:
    """The shape of a batch of audio frames."""
    return (batch, cfg.encdec.encoder_seq_len, cfg.d_model)


def vision_patches_spec(batch: int, cfg: ArchConfig) -> tuple:
    """The shape of a batch of vision patches."""
    return (batch, cfg.vlm.num_vision_tokens, cfg.d_model)
