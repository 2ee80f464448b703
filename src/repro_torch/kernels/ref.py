"""Plain PyTorch versions of the port's kernels.

These are the source of truth on the CPU and the yardstick of correctness
on the card: each kernel must match its plain version here.  The
backward versions are eager PyTorch, one op per step; they compute what
autodiff of :func:`merge_pool` computes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import merge as merge_lib


def merge_pool(stacked: torch.Tensor, strategy: str,
               live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """stacked: (K, B, D) -> (B, D) for the reductions, (B, K*D) for the
    gather-concat."""
    if strategy not in ("sum", "avg", "max", "mul", "concat"):
        raise ValueError(f"unknown merge {strategy!r}")
    return merge_lib.merge_stacked(stacked, strategy, live_mask=live)


def merge_pool_bwd(stacked: Optional[torch.Tensor], live: torch.Tensor,
                   out: Optional[torch.Tensor], g: torch.Tensor,
                   strategy: str) -> torch.Tensor:
    """The reductions' jacobian splitting: ``g`` (B, D), the merged
    output's gradient, -> ``dx`` (K, B, D) in ``g``'s dtype, computed in
    f32.  ``stacked`` is read by max and mul, ``out`` by max only.

    mul takes the product of the OTHER live clients (exclusive prefix times
    exclusive suffix), which is autodiff's answer at a live zero, where
    ``out / x_k`` would give 0/0."""
    K = live.shape[0]
    lv = live.to(torch.float32).reshape(K, 1, 1)
    g32 = g.to(torch.float32)[None]
    if strategy == "sum":
        dx = g32 * lv
    elif strategy == "avg":
        n_live = torch.clamp(torch.sum(live.to(torch.float32)), min=1.0)
        dx = g32 * (lv / n_live)
    elif strategy == "max":
        holds = (stacked.to(torch.float32) == out.to(torch.float32)[None]) \
            & (lv > 0)
        ties = torch.clamp(torch.sum(holds.to(torch.float32), dim=0), min=1.0)
        dx = torch.where(holds, g32 / ties, torch.zeros_like(g32))
    elif strategy == "mul":
        masked = torch.where(lv > 0, stacked.to(torch.float32),
                             torch.ones_like(g32))
        ones = torch.ones_like(masked[:1])
        prefix = torch.cumprod(torch.cat([ones, masked[:-1]]), dim=0)
        suffix = torch.flip(torch.cumprod(
            torch.flip(torch.cat([masked[1:], ones]), [0]), dim=0), [0])
        dx = torch.where(lv > 0, g32 * (prefix * suffix),
                         torch.zeros_like(g32))
    else:
        raise ValueError(f"unknown merge {strategy!r} for the reduction "
                         "backward")
    return dx.to(g.dtype)


def concat_bwd(live: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """The concat's jacobian splitting: client k's gradient is its own
    column block of ``g`` (B, k*D), zeroed when it was dropped."""
    B = g.shape[0]
    blocks = g.to(torch.float32).reshape(B, k, -1).permute(1, 0, 2)
    return (blocks * live.to(torch.float32).reshape(k, 1, 1)).to(g.dtype)


#: q rows per block of :func:`flash_attention`: bounds its score matrix to
#: ``B * H * FLASH_ROWS * S`` floats, so it runs at 32k tokens on one card
FLASH_ROWS = 1024


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q ``(B, H, S, D)``, k and v ``(B, Hkv, S, D)`` with ``H % Hkv == 0``
    (kv head ``h // (H // Hkv)`` serves q head ``h``) -> ``(B, H, S, D)``
    in q's dtype: a plain f32 softmax over every full row of scores,
    scaled by ``1/sqrt(D)``, masked at ``-1e30`` above the diagonal when
    causal.  Rows are taken ``FLASH_ROWS`` at a time, each block an exact
    full-row softmax; the JAX package's ``ref.flash_attention`` with the
    kv heads repeated."""
    return _flash_rows(q, k, v, causal, with_lse=False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True):
    """:func:`flash_attention` and each row's logsumexp of its scaled,
    masked scores: ``(o, lse)``, lse f32 ``(B, H, S)`` (what the kernel
    writes for its backward)."""
    return _flash_rows(q, k, v, causal, with_lse=True)


def _flash_rows(q, k, v, causal, with_lse):
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    kf = k.to(torch.float32).repeat_interleave(rep, dim=1)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=1)
    scale = 1.0 / D ** 0.5
    cols = torch.arange(S, device=q.device)
    blocks, lses = [], []
    for r0 in range(0, S, FLASH_ROWS):
        qb = q[:, :, r0:r0 + FLASH_ROWS].to(torch.float32)
        s = torch.einsum("bhqd,bhkd->bhqk", qb, kf) * scale
        if causal:
            rows = cols[r0:r0 + FLASH_ROWS]
            s = s.masked_fill(rows[:, None] < cols[None, :], -1e30)
        p = torch.softmax(s, dim=-1)
        blocks.append(torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype))
        if with_lse:
            lses.append(torch.logsumexp(s, dim=-1))
    return (torch.cat(blocks, dim=2),
            torch.cat(lses, dim=2) if with_lse else None)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True):
    """The backward of :func:`flash_attention` written out, no autograd
    inside (the plain twin of ``kernels.flash_attention.
    flash_attention_bwd``): the forward's q ``(B, H, S, D)``, k and v
    ``(B, Hkv, S, D)``, its output ``o``, its logsumexp ``lse`` f32
    ``(B, H, S)`` and the output's gradient ``do`` -> ``(dq, dk, dv)`` in
    the inputs' shapes and dtype, computed in f32, ``FLASH_ROWS`` q rows
    at a time.  With ``P = exp(Q K^T / sqrt(D) - lse)`` (0 where masked)
    and ``Delta = rowsum(dO o O)``:

      dV = P^T dO,   dS = P o (dO V^T - Delta),
      dQ = dS K / sqrt(D),   dK = dS^T Q / sqrt(D),

    dk and dv summed over each kv head's group of q heads."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    f32 = torch.float32
    kf = k.to(f32).repeat_interleave(rep, dim=1)
    vf = v.to(f32).repeat_interleave(rep, dim=1)
    scale = 1.0 / D ** 0.5
    delta = torch.sum(do.to(f32) * o.to(f32), dim=-1)
    cols = torch.arange(S, device=q.device)
    dq = torch.empty((B, H, S, D), dtype=f32, device=q.device)
    dk = torch.zeros((B, H, S, D), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, S, FLASH_ROWS):
        r1 = min(r0 + FLASH_ROWS, S)
        qb = q[:, :, r0:r1].to(f32)
        dob = do[:, :, r0:r1].to(f32)
        s = torch.einsum("bhqd,bhkd->bhqk", qb, kf) * scale
        p = torch.exp(s - lse[:, :, r0:r1, None].to(f32))
        if causal:
            p = p.masked_fill(cols[r0:r1, None] < cols[None, :], 0.0)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dob)
        dp = torch.einsum("bhqd,bhkd->bhqk", dob, vf)
        ds = p * (dp - delta[:, :, r0:r1, None])
        dq[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qb) * scale
    dk = dk.reshape(B, Hkv, rep, S, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, rep, S, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_chunk(x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
              Cm: torch.Tensor):
    """The quadratic intra-chunk SSD term, batched over leading dims G
    (which broadcast: B/C shared by every head pass as ``(..., 1, Q, N)``).

    x ``(G, Q, P)`` inputs already scaled by dt, a ``(G, Q)`` log-decays
    (dt * A, negative), Bm and Cm ``(G, Q, N)``.  Returns, in f32:
      y_intra ``(G, Q, P)`` = ``((C B^T) o L) x`` with
        ``L[i, j] = exp(cum_i - cum_j)`` for ``i >= j``, else 0;
      state ``(G, P, N)`` = ``sum_j exp(cum_Q - cum_j) x_j B_j^T``;
      decay ``(G,)`` = ``exp(cum_Q)``, the inter-chunk carry factor;
      cum ``(G, Q)`` = ``cumsum(a)``.
    The JAX package's ``ref.ssd_chunk`` for one chunk, batched."""
    Q = x.shape[-2]
    xf, af = x.to(torch.float32), a.to(torch.float32)
    Bf, Cf = Bm.to(torch.float32), Cm.to(torch.float32)
    cum = torch.cumsum(af, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    # masked before the exponential: above the diagonal diff is positive
    # and may overflow, and autograd of a where over exp(diff) would give
    # inf * 0 = NaN there
    L = torch.exp(diff.masked_fill(~lower, float("-inf")))
    scores = (Cf @ Bf.transpose(-1, -2)) * L
    y_intra = scores @ xf
    decay_to_end = torch.exp(cum[..., -1:] - cum)
    state = (xf * decay_to_end[..., None]).transpose(-1, -2) @ Bf
    return y_intra, state, torch.exp(cum[..., -1]), cum


def ssd_chunks(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, chunk: int):
    """:func:`ssd_chunk` over every chunk of a sequence, in the layouts the
    CUDA kernel reads and writes (the plain twin of
    ``kernels.ssd_scan.ssd_chunk``).

    xdt ``(B, S, H, P)``, a ``(B, S, H)``, Bm and Cm ``(B, S, N)`` (one
    group, shared by every head), ``chunk`` dividing S.  Returns y_intra
    ``(B, S, H, P)``, state ``(B, nc, H, P, N)``, decay ``(B, nc, H)`` and
    cum ``(B, S, H)``, all f32 and contiguous."""
    Bsz, S, H, P = xdt.shape
    N = Bm.shape[-1]
    nc = S // chunk
    xg = xdt.reshape(Bsz, nc, chunk, H, P).permute(0, 1, 3, 2, 4)
    ag = a.reshape(Bsz, nc, chunk, H).permute(0, 1, 3, 2)
    Bg = Bm.reshape(Bsz, nc, 1, chunk, N)
    Cg = Cm.reshape(Bsz, nc, 1, chunk, N)
    y, state, decay, cum = ssd_chunk(xg, ag, Bg, Cg)
    y = y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P)
    cum = cum.permute(0, 1, 3, 2).reshape(Bsz, S, H)
    return y, state.contiguous(), decay.contiguous(), cum


def ssd_chunks_bwd(xdt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, gy: Optional[torch.Tensor],
                   gstate: Optional[torch.Tensor],
                   gcum: Optional[torch.Tensor], chunk: int):
    """The backward of :func:`ssd_chunks` in its own layouts, written out
    (the plain twin of ``kernels.ssd_scan.ssd_chunk_bwd``).

    Takes the forward's inputs and the upstream gradients of y_intra
    ``gy (B, S, H, P)``, of the states ``gstate (B, nc, H, P, N)`` and of
    cum ``gcum (B, S, H)``; any of them may be None (zero).  decay has no
    gradient path: ``ops.ssd_scan`` reads cum instead.  Per (batch, chunk,
    head), with M = (C B^T) o L, w_j = exp(cum_Q - cum_j) and dM = gy x^T
    masked to i >= j:

      dx   = M^T gy + w o (B gS^T)
      dC   = (dM o L) B
      dB   = (dM o L)^T C + (x o w) gS
      dcum = rowsum(R) - colsum(R) - T + [j = Q-1] sum(T) + gcum,
             R = dM o M,  T_j = w_j sum_p x_jp (B gS^T)_jp

    and da is the reverse cumsum of dcum.  B and C are shared by every
    head (one group), so dB and dC are summed over the heads.  Returns
    dxdt ``(B, S, H, P)``, da ``(B, S, H)``, dB and dC ``(B, S, N)``, f32
    and contiguous."""
    Bsz, S, H, P = xdt.shape
    N = Bm.shape[-1]
    Q, nc = chunk, S // chunk
    f32 = torch.float32

    def heads_last(t, width):  # (B, S, H, width) -> (B, nc, H, Q, width)
        return t.to(f32).reshape(Bsz, nc, Q, H, width).permute(0, 1, 3, 2, 4)

    x = heads_last(xdt, P)
    cum = torch.cumsum(heads_last(a[..., None], 1)[..., 0], dim=-1)
    Bg = Bm.to(f32).reshape(Bsz, nc, 1, Q, N)
    Cg = Cm.to(f32).reshape(Bsz, nc, 1, Q, N)
    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~lower, float("-inf")))
    M = (Cg @ Bg.transpose(-1, -2)) * L
    w = torch.exp(cum[..., -1:] - cum)
    dx = torch.zeros_like(x)
    dcum = torch.zeros_like(cum)
    dB = torch.zeros((Bsz, nc, Q, N), dtype=f32, device=x.device)
    dC = torch.zeros_like(dB)
    if gy is not None:
        g = heads_last(gy, P)
        dM = (g @ x.transpose(-1, -2)).masked_fill(~lower, 0.0)
        dG = dM * L
        R = dM * M
        dcum = dcum + R.sum(-1) - R.sum(-2)
        dx = dx + M.transpose(-1, -2) @ g
        dC = dC + (dG @ Bg).sum(2)
        dB = dB + (dG.transpose(-1, -2) @ Cg).sum(2)
    if gstate is not None:
        gS = gstate.to(f32)
        V = Bg @ gS.transpose(-1, -2)  # (B, nc, H, Q, P)
        dx = dx + w[..., None] * V
        dB = dB + ((x * w[..., None]) @ gS).sum(2)
        T = w * (x * V).sum(-1)
        dcum = dcum - T
        dcum[..., -1] += T.sum(-1)
    if gcum is not None:
        dcum = dcum + heads_last(gcum[..., None], 1)[..., 0]
    da = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), dim=-1), [-1])
    return (dx.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P).contiguous(),
            da.permute(0, 1, 3, 2).reshape(Bsz, S, H).contiguous(),
            dB.reshape(Bsz, S, N), dC.reshape(Bsz, S, N))
