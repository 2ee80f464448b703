"""Configuration system: the port's own copy of the JAX package's configs.

The port keeps its own copy (it imports nothing of the JAX package) of the
configs it runs: smollm-360m, starcoder2-3b, stablelm-3b and qwen3-32b
(dense), mamba2-1.3b (ssm), zamba2-7b (hybrid), deepseek-moe-16b and
arctic-480b (moe), whisper-tiny (audio) and internvl2-26b (vlm).
``tests/test_torch_model.py`` checks every field against the JAX
package's ``ArchConfig`` so the two copies cannot drift.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

MERGE_STRATEGIES = ("concat", "sum", "avg", "max", "mul")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts layer configuration."""

    num_experts: int
    top_k: int
    # deepseek-style always-on shared experts (0 = none)
    num_shared_experts: int = 0
    # arctic-style dense FFN residual in parallel with the MoE FFN
    dense_residual: bool = False
    d_ff_dense_residual: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # first `first_dense_layers` layers use a plain dense FFN (deepseek-moe)
    first_dense_layers: int = 0


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
class HybridConfig:
    """Zamba2-style hybrid: shared attention block every N Mamba layers."""

    shared_attn_every: int = 6  # one shared-weight attn block per 6 mamba layers


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder; the conv/mel frontend is a stub."""

    encoder_layers: int = 4
    encoder_seq_len: int = 1500  # whisper: 30 s audio -> 1500 frames


@dataclass(frozen=True)
class VLMConfig:
    """InternVL-style: vision patch embeddings (stub) prepended to text."""

    num_vision_tokens: int = 1024


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
    """One architecture."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
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
        """Smoke-test variant: 2 layers, d_model <= 256, 2 clients; a moe
        keeps <= 4 experts, top-2, <= 1 shared expert, a dense residual of
        <= 512 and <= 1 first dense layer, an ssm d_state <= 16 and chunks
        of 32, a hybrid a shared attention block after every Mamba
        layer, an encoder-decoder 2 encoder layers over 16 frames, a vlm
        8 vision tokens."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4) or 4
        kv = min(self.num_kv_heads, heads) or heads
        while heads % kv:  # at least 1 kv head, dividing heads
            kv -= 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                d_ff_dense_residual=min(self.moe.d_ff_dense_residual, 512)
                if self.moe.dense_residual
                else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1),
            )
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm,
                                      d_state=min(self.ssm.d_state, 16),
                                      chunk_size=32)
        hybrid = None
        if self.hybrid is not None:
            hybrid = dataclasses.replace(self.hybrid, shared_attn_every=1)
        encdec = None
        if self.encdec is not None:
            encdec = dataclasses.replace(self.encdec, encoder_layers=2,
                                         encoder_seq_len=16)
        vlm = None
        if self.vlm is not None:
            vlm = dataclasses.replace(self.vlm, num_vision_tokens=8)
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
            moe=moe,
            ssm=ssm,
            hybrid=hybrid,
            encdec=encdec,
            vlm=vlm,
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
    from repro_torch.configs import (arctic_480b,  # noqa: F401
                                     deepseek_moe_16b, internvl2_26b,
                                     mamba2_1_3b, qwen3_32b, smollm_360m,
                                     stablelm_3b, starcoder2_3b,
                                     whisper_tiny, zamba2_7b)
