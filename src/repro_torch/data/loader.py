"""Batch loader for the token-LM families: the JAX package's
``LMBatchLoader`` without its sharding branch (one process feeds one card)
and for the dense, moe, ssm and hybrid families only (the token stream alone:
no audio frames or vision patches).  Batches are dicts of int32 numpy arrays,
``tokens`` and ``labels`` of shape (batch, seq_len)."""
from __future__ import annotations

from typing import Iterator

from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import ZipfMotifStream


class LMBatchLoader:
    def __init__(self, cfg: ArchConfig, batch: int, seq_len: int,
                 seed: int = 0):
        if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
            raise NotImplementedError(
                f"{cfg.name}: the port's loader feeds the dense, moe, ssm "
                f"and hybrid families only (got {cfg.family!r})")
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.stream = ZipfMotifStream(cfg.vocab_size, seed)

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> dict:
        return self.stream.batch(self.batch, self.seq_len)
