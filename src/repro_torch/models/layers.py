"""Foundational layers: norms (RMSNorm, LayerNorm), RoPE and the sinusoidal
positions, the gated and GELU MLPs, embeddings.

Functional, like the JAX package: ``init_*`` builds a param dict of
tensors, the apply functions consume it.  Init functions take a
``torch.Generator`` (its device is where the tensors are made) and a
``lead`` shape prefix, so that a stack of L layers is drawn in one call as
one ``(L, ...)`` tensor — the JAX package's stacked layout.
"""
from __future__ import annotations

import functools
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
    +-2, times 1/sqrt(d_in) — the JAX package's ``dense_init``.  Drawn in
    f32; a stack in another dtype is drawn layer by layer, so that no f32
    copy of the whole stack is ever held (qwen3-32b's bf16 MLP stacks are
    16 GB each, 32 GB in f32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)

    def draw(shape):
        w = torch.empty(shape, dtype=torch.float32, device=gen.device)
        torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                    generator=gen)
        return w.mul_(scale)

    if dtype == torch.float32 or not lead:
        return draw(lead + (d_in, d_out)).to(dtype)
    out = torch.empty(lead + (d_in, d_out), dtype=dtype, device=gen.device)
    for layer in out.view(-1, d_in, d_out):
        layer.copy_(draw((d_in, d_out)))
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return w.mul_(0.02).to(dtype)


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


def init_layernorm(d: int, *, lead: tuple = (), device=None,
                   dtype=torch.float32) -> dict:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Mean and biased variance (``jnp.var``) in f32, then scale and bias
    in f32, back to the activation dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


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


def _sinusoid_freqs(d: int, device) -> torch.Tensor:
    half = d // 2
    log_timescale = math.log(10000.0) / max(half - 1, 1)
    return torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                   device=device))


def sinusoidal_positions(seq_len: int, d: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings ``(seq_len, d)``: sin then cos
    of ``position * exp(-log(1e4) / max(d/2 - 1, 1) * i)``, in f32."""
    scaled = torch.arange(seq_len, dtype=torch.float32, device=device)[
        :, None] * _sinusoid_freqs(d, device)[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1).to(
        dtype)


def sinusoidal_position_at(position: torch.Tensor, d: int,
                           dtype=torch.float32) -> torch.Tensor:
    """The sinusoidal embeddings at ``position`` (any shape): ``position.
    shape + (d,)``."""
    scaled = position.float()[..., None] * _sinusoid_freqs(d,
                                                           position.device)
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1).to(
        dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_gated_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
                   lead: tuple = (), dtype=torch.float32) -> dict:
    """SwiGLU MLP (llama-style)."""
    return {
        "w_gate": dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype),
        "w_up": dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype),
        "w_down": dense_init(gen, d_ff, d_model, lead=lead, dtype=dtype),
    }


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the operands promoted as ``jnp`` promotes them: f32 @
    bf16 is an f32 product (torch refuses mixed operands).  A server decode
    step whose batch holds an idle slot's f32 zero cut beside bf16 cuts
    runs in f32 against a bf16 tree, as in the JAX package."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(dtype) @ w.to(dtype)


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the operands promoted as ``jnp.einsum``
    promotes them (torch refuses mixed operands), as :func:`matmul`."""
    dtype = functools.reduce(torch.promote_types,
                             (op.dtype for op in operands))
    return torch.einsum(equation, *(op.to(dtype) for op in operands))


def gated_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(matmul(x, params["w_gate"]))
    up = matmul(x, params["w_up"])
    return matmul(gate * up, params["w_down"])


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
                  lead: tuple = (), dtype=torch.float32) -> dict:
    """GELU MLP (whisper-style, no gate), with biases."""
    return {
        "w_in": dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype),
        "b_in": torch.zeros(lead + (d_ff,), dtype=dtype, device=gen.device),
        "w_out": dense_init(gen, d_ff, d_model, lead=lead, dtype=dtype),
        "b_out": torch.zeros(lead + (d_model,), dtype=dtype,
                             device=gen.device),
    }


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``: the tanh form."""
    h = F.gelu(matmul(x, params["w_in"]) + params["b_in"], approximate="tanh")
    return matmul(h, params["w_out"]) + params["b_out"]


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
        return matmul(x, params["unembed"])
    return matmul(x, params["table"].T)
