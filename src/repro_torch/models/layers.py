"""Foundational layers: norms, RoPE, the gated MLP, embeddings.

Functional, like the JAX package: ``init_*`` builds a param dict of
tensors, the apply functions consume it.  Init functions take a
``torch.Generator`` (its device is where the tensors are made) and a
``lead`` shape prefix, so that a stack of L layers is drawn in one call as
one ``(L, ...)`` tensor — the JAX package's stacked layout.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               lead: tuple = (), dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style): a standard normal cut at
    +-2, times 1/sqrt(d_in) — the JAX package's ``dense_init``."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.empty(lead + (d_in, d_out), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, *, lead: tuple = (), device=None,
                 dtype=torch.float32) -> dict:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # variance in f32 regardless of activation dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    inv_freq = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * inv_freq  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_gated_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
                   lead: tuple = (), dtype=torch.float32) -> dict:
    """SwiGLU MLP (llama-style)."""
    return {
        "w_gate": dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype),
        "w_up": dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype),
        "w_down": dense_init(gen, d_ff, d_model, lead=lead, dtype=dtype),
    }


def gated_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ params["w_gate"])
    up = x @ params["w_up"]
    return (gate * up) @ params["w_down"]


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int, *,
                   dtype=torch.float32, tie: bool = False) -> dict:
    params = {"table": embed_init(gen, vocab, d_model, dtype)}
    if not tie:
        params["unembed"] = dense_init(gen, d_model, vocab, dtype=dtype)
    return params


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["table"].T
