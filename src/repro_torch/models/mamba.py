"""Mamba2 (SSD — state-space duality) block, faithful to arXiv:2405.21060:
the JAX package's ``models/mamba.py``.

Full-sequence path: chunked SSD — the intra-chunk quadratic term plus the
inter-chunk linear state recurrence.  :func:`mamba_apply` sends it to the
SSD chunk kernel (``kernels/ops.ssd_scan``: the CUDA kernels on the card,
forward and backward, their plain versions on the CPU) or, with
``use_kernel=False``, to the model's own :func:`ssd_chunked`, as the JAX
model runs it.  Decode path: the exact single-step recurrence with a
conv ring state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops
from repro_torch.models import layers


def init_mamba(gen: torch.Generator, d_model: int, cfg: SSMConfig, *,
               lead: tuple = (), dtype=torch.float32) -> dict:
    """The JAX package's init distributions: ``A = -exp(A_log)`` with
    ``exp(A_log)`` uniform in [1, 16]; ``dt_bias = softplus^-1(dt)`` with
    dt uniform in [1e-3, 1e-1]; ``D = 1``; ``conv_w`` normal / sqrt(W).
    ``A_log``, ``dt_bias`` and ``D`` stay f32 whatever ``dtype`` is."""
    d_inner = cfg.d_inner(d_model)
    H = cfg.n_heads(d_model)
    G, N, W = cfg.n_groups, cfg.d_state, cfg.conv_width
    d_conv_ch = d_inner + 2 * G * N  # conv runs over [x, B, C]
    d_proj = 2 * d_inner + 2 * G * N + H  # [z, x, B, C, dt]
    dev = gen.device

    def uniform(low, high):
        u = torch.rand(lead + (H,), generator=gen, device=dev)
        return low + (high - low) * u

    conv_w = torch.randn(lead + (W, d_conv_ch), generator=gen, device=dev)
    return {
        "in_proj": layers.dense_init(gen, d_model, d_proj, lead=lead,
                                     dtype=dtype),
        "conv_w": (conv_w / math.sqrt(W)).to(dtype),
        "conv_b": torch.zeros(lead + (d_conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.log(uniform(1.0, 16.0)),
        "dt_bias": torch.log(torch.expm1(uniform(1e-3, 1e-1))),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=dev),
        "norm": layers.init_rmsnorm(d_inner, lead=lead, device=dev,
                                    dtype=dtype),
        "out_proj": layers.dense_init(gen, d_inner, d_model, lead=lead,
                                      dtype=dtype),
    }


def _split_proj(proj: torch.Tensor, d_inner: int, G: int, N: int, H: int):
    """[z, x, B, C, dt] along the last axis."""
    return torch.split(proj, [d_inner, d_inner, G * N, G * N, H], dim=-1)


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, u: (B, S, ch), w: (W, ch)."""
    W, S = w.shape[0], u.shape[1]
    pads = [F.pad(u, (0, 0, W - 1 - i, 0))[:, :S, :] * w[i]
            for i in range(W)]
    return sum(pads) + b


def _segsum_exp(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) log-decays -> L: (..., Q, Q) with
    L[i, j] = exp(sum_{j < t <= i} a_t), lower-triangular (i >= j), zero
    elsewhere."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    lower = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    # masked before the exponential, so that autograd meets no inf * 0
    # above the diagonal, where diff is positive and may overflow
    return torch.exp(diff.masked_fill(~lower, float("-inf")))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor, chunk: int,
                initial_state=None):
    """Chunked SSD scan, any number of groups (the model's own path).

    x ``(B, S, H, P)`` inputs per head, dt ``(B, S, H)`` positive step
    sizes, A ``(H,)`` negative decay rates, Bmat and Cmat ``(B, S, G, N)``
    (G groups, GQA-style).  Returns (y ``(B, S, H, P)``, final state
    ``(B, H, P, N)``).  A Python loop over the chunks takes the place of
    the JAX package's ``lax.scan``."""
    Bsz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: chunk {Q} does not divide the "
                         f"sequence length {S}")
    nc = S // Q

    a = (dt * A[None, None, :]).to(torch.float32)  # (B, S, H), negative
    xdt = (x * dt[..., None]).to(torch.float32)  # (B, S, H, P)
    ac = a.reshape(Bsz, nc, Q, H)
    xc = xdt.reshape(Bsz, nc, Q, H, P)
    Bc = Bmat.reshape(Bsz, nc, Q, G, N).to(torch.float32)
    Cc = Cmat.reshape(Bsz, nc, Q, G, N).to(torch.float32)

    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state)
    ys = []
    for c in range(nc):
        a_q, x_q = ac[:, c], xc[:, c]
        cum = torch.cumsum(a_q, dim=1)
        L = _segsum_exp(a_q.movedim(1, -1))
        C_rep = torch.repeat_interleave(Cc[:, c], rep, dim=2)  # (B,Q,H,N)
        B_rep = torch.repeat_interleave(Bc[:, c], rep, dim=2)
        scores = torch.einsum("bqhn,bkhn->bhqk", C_rep, B_rep)
        y_intra = torch.einsum("bhqk,bkhp->bqhp", scores * L, x_q)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", C_rep, state) * \
            torch.exp(cum)[..., None]
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)
        new_contrib = torch.einsum("bqhn,bqhp->bhpn", B_rep,
                                   x_q * decay_to_end[..., None])
        full_decay = torch.exp(cum[:, -1, :])
        state = state * full_decay[:, :, None, None] + new_contrib
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y, state


def mamba_apply(params: dict, x: torch.Tensor, cfg: SSMConfig, d_model: int,
                *, use_kernel: bool = True):
    """Full-sequence forward.  Returns (out, final_ssm_state, conv_tail).

    ``use_kernel`` (the default) sends the SSD scan to ``ops.ssd_scan``:
    the CUDA chunk kernels for CUDA tensors (forward, and backward when
    autograd differentiates the call), their plain versions for CPU
    tensors; that path takes one group only and raises otherwise rather
    than fall back.  ``use_kernel=False`` runs the model's own
    :func:`ssd_chunked` on any device, as the JAX model does.  Nothing
    here writes in place, so autograd may save any intermediate."""
    d_inner = cfg.d_inner(d_model)
    H, G, N, W = cfg.n_heads(d_model), cfg.n_groups, cfg.d_state, \
        cfg.conv_width
    P = cfg.head_dim
    Bsz, S, _ = x.shape

    proj = x @ params["in_proj"]
    z, xs, Bm, Cm, dt = _split_proj(proj, d_inner, G, N, H)
    u = torch.cat([xs, Bm, Cm], dim=-1)
    u = F.silu(_causal_conv(u, params["conv_w"], params["conv_b"]))
    xs, Bm, Cm = torch.split(u, [d_inner, G * N, G * N], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])  # (B, S, H)
    A = -torch.exp(params["A_log"])  # (H,)
    xh = xs.reshape(Bsz, S, H, P)
    Bm = Bm.reshape(Bsz, S, G, N)
    Cm = Cm.reshape(Bsz, S, G, N)

    scan = ops.ssd_scan if use_kernel else ssd_chunked
    y, state = scan(xh, dt, A, Bm, Cm, cfg.chunk_size)
    # from here the JAX model's dtypes: the scan's y in the activations'
    # dtype (ops.ssd_scan returns f32), promoted to f32 by the f32 D, and
    # the out projection in f32 (JAX promotes a bf16 weight to it)
    y = y.to(xh.dtype) + params["D"][None, None, :, None] * xh
    y = y.reshape(Bsz, S, d_inner)
    y = layers.rmsnorm(params["norm"], y) * F.silu(z)
    out = (y @ params["out_proj"].to(y.dtype)).to(x.dtype)
    conv_tail = torch.cat([xs, Bm.reshape(Bsz, S, G * N),
                           Cm.reshape(Bsz, S, G * N)], dim=-1)[:, -(W - 1):]
    return out, state, conv_tail


def mamba_decode_step(params: dict, x: torch.Tensor, ssm_state: torch.Tensor,
                      conv_state: torch.Tensor, cfg: SSMConfig,
                      d_model: int):
    """One-token decode: the exact recurrence.

    x ``(B, 1, d_model)``, ssm_state ``(B, H, P, N)``, conv_state
    ``(B, W-1, ch)``.  Returns (out, new_ssm_state, new_conv_state)."""
    d_inner = cfg.d_inner(d_model)
    H, G, N = cfg.n_heads(d_model), cfg.n_groups, cfg.d_state
    P = cfg.head_dim
    Bsz = x.shape[0]

    proj = x[:, 0, :] @ params["in_proj"]  # (B, d_proj)
    z, xs, Bm, Cm, dt = _split_proj(proj, d_inner, G, N, H)
    u_new = torch.cat([xs, Bm, Cm], dim=-1)  # (B, ch)
    window = torch.cat([conv_state, u_new[:, None, :]], dim=1)  # (B, W, ch)
    # an f32 cache (generate's) promotes the window, and with it the
    # product, to f32 over a bf16 conv_w, as jnp.einsum promotes
    conv_w = params["conv_w"].to(torch.promote_types(window.dtype,
                                                     params["conv_w"].dtype))
    u = torch.einsum("bwc,wc->bc", window.to(conv_w.dtype), conv_w) + \
        params["conv_b"]
    u = F.silu(u)
    xs, Bm, Cm = torch.split(u, [d_inner, G * N, G * N], dim=-1)

    dt = F.softplus(dt.to(torch.float32) + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)  # (B, H)
    xh = xs.reshape(Bsz, H, P).to(torch.float32)
    B_rep = torch.repeat_interleave(Bm.reshape(Bsz, G, N), H // G,
                                    dim=1).to(torch.float32)
    C_rep = torch.repeat_interleave(Cm.reshape(Bsz, G, N), H // G,
                                    dim=1).to(torch.float32)

    new_state = ssm_state * decay[:, :, None, None] + \
        torch.einsum("bhn,bhp->bhpn", B_rep, xh * dt[..., None])
    y = torch.einsum("bhn,bhpn->bhp", C_rep, new_state)  # (B, H, P)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(Bsz, d_inner).to(x.dtype)
    y = layers.rmsnorm(params["norm"], y) * F.silu(z)
    out = (y @ params["out_proj"]).to(x.dtype)[:, None, :]
    return out, new_state, window[:, 1:, :]
