"""Batch loader: the JAX package's ``LMBatchLoader`` without its sharding
branch (one process feeds one card).  Batches are dicts of numpy arrays:
``tokens`` and ``labels`` (int32, ``(batch, seq_len)``) from the shared
token stream, plus for the audio family ``frames`` ``(batch,
encoder_seq_len, d_model)`` and for the vlm family ``patches`` ``(batch,
num_vision_tokens, d_model)``, f32, drawn from
``np.random.default_rng(seed + 1)`` times 0.5 exactly as the JAX package
draws them (so the two packages' batches are equal).  A vlm batch's text
is its first ``seq_len - num_vision_tokens`` tokens: the sequence the
server sees is ``seq_len`` long."""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import ZipfMotifStream


def to_tensor(array, device) -> torch.Tensor:
    """A batch's array on ``device``: token ids and labels as int64,
    frames and patches in their own dtype (f32)."""
    t = torch.as_tensor(np.ascontiguousarray(array), device=device)
    return t if t.is_floating_point() else t.long()


class LMBatchLoader:
    def __init__(self, cfg: ArchConfig, batch: int, seq_len: int,
                 seed: int = 0):
        if cfg.family == "vlm" and seq_len <= cfg.vlm.num_vision_tokens:
            raise ValueError(
                f"{cfg.name}: a vlm sequence of {seq_len} leaves no text "
                f"after its {cfg.vlm.num_vision_tokens} vision tokens; "
                "seq_len must exceed them")
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.stream = ZipfMotifStream(cfg.vocab_size, seed)
        self.rng = np.random.default_rng(seed + 1)

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        b = self.stream.batch(self.batch, self.seq_len)
        if self.cfg.family == "audio":
            n = self.cfg.encdec.encoder_seq_len
            b["frames"] = self.rng.normal(
                size=(self.batch, n, self.cfg.d_model)
            ).astype(np.float32) * 0.5
        elif self.cfg.family == "vlm":
            nv = self.cfg.vlm.num_vision_tokens
            b["patches"] = self.rng.normal(
                size=(self.batch, nv, self.cfg.d_model)
            ).astype(np.float32) * 0.5
            b["tokens"] = b["tokens"][:, : self.seq_len - nv]
            b["labels"] = b["labels"][:, : self.seq_len - nv]
        return b
