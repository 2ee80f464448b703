"""Configuration system: the port's own copy of the JAX package's configs.

The port keeps its own copy (it imports nothing of the JAX package) of the
configs it runs: smollm-360m, starcoder2-3b and mamba2-1.3b.  Only the
fields the dense and ssm token-LM families read are carried; the
sub-configs of the other families (moe, hybrid, audio, vlm) come with their
slices.
``tests/test_torch_model.py`` checks the shared fields against the JAX
package's ``ArchConfig`` so the two copies cannot drift.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

MERGE_STRATEGIES = ("concat", "sum", "avg", "max", "mul")


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""

    d_state: int
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk_size: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class VerticalConfig:
    """The paper's technique: K client towers + merge at the cut layer.

    Clients hold vertical slices of the feature space (for LMs: d_model
    slices).  ``tower_layers`` transformer layers of width d_model/K run per
    client with no cross-client communication; outputs are merged with
    ``merge`` and the remaining layers form the server network.
    """

    num_clients: int = 4
    tower_layers: int = 2
    merge: str = "avg"  # one of MERGE_STRATEGIES
    secure_aggregation: bool = False
    compression: Optional[str] = None  # None | "topk" | "int8"
    topk_fraction: float = 0.25

    def __post_init__(self):
        if self.merge not in MERGE_STRATEGIES:
            raise ValueError(f"merge must be one of {MERGE_STRATEGIES}, "
                             f"got {self.merge!r}")
        from repro_torch.core import compat

        compat.check("config", secure=self.secure_aggregation,
                     merge=self.merge,
                     context=f"VerticalConfig(merge={self.merge!r})")


@dataclass(frozen=True)
class ArchConfig:
    """One architecture (the dense and ssm token-LM fields)."""

    name: str
    family: str  # dense | ssm (the families the port runs so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 8192
    ssm: Optional[SSMConfig] = None
    vertical: Optional[VerticalConfig] = None
    source: str = ""  # provenance citation

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def with_vertical(self, vertical: Optional[VerticalConfig]) -> "ArchConfig":
        return dataclasses.replace(self, vertical=vertical)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model <= 256, 2 clients; an ssm
        keeps d_state <= 16 and chunks of 32."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4) or 4
        kv = min(self.num_kv_heads, heads) or heads
        while heads % kv:  # at least 1 kv head, dividing heads
            kv -= 1
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm,
                                      d_state=min(self.ssm.d_state, 16),
                                      chunk_size=32)
        vertical = self.vertical
        if vertical is not None:
            vertical = dataclasses.replace(vertical, tower_layers=1,
                                           num_clients=2)
        return dataclasses.replace(
            self,
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=0,
            sliding_window=64,
            ssm=ssm,
            vertical=vertical,
        )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _ensure_loaded() -> None:
    # import the config modules for their registration side effects
    from repro_torch.configs import (mamba2_1_3b, smollm_360m,  # noqa: F401
                                     starcoder2_3b)
