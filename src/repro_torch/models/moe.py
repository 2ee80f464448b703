"""Mixture-of-experts: top-k router + einsum dispatch/combine.

The JAX package's formulation, step for step (its drop semantics depend
on the order): tokens are cut into groups of about 512, each group's
tokens queue at their experts in token-major order, and a (token, k)
pair past its expert's capacity is dropped (the residual passes it
through).  The dispatch and combine are one-hot products, plain
``einsum`` on both devices, as they are plain ``jnp`` in the reference.
Supports deepseek-style shared experts and arctic-style dense residuals.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import layers


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, cfg: MoEConfig,
             *, lead: tuple = (), dtype=torch.float32) -> dict:
    """One MoE FFN, or a stack of them with ``lead=(L,)``.  The router is
    f32 whatever ``dtype`` is, as in the JAX package.  The expert stacks
    ``lead + (E, d, ff)`` go through ``layers.dense_init``, which draws a
    non-f32 stack matrix by matrix, so no f32 copy of a stack is held
    (arctic-480b's ``w_gate`` alone would be 17.8 GB in f32 at one
    layer)."""
    E = cfg.num_experts
    p = {
        "router": layers.dense_init(gen, d_model, E, lead=lead,
                                    dtype=torch.float32),
        "w_gate": layers.dense_init(gen, d_model, d_ff, lead=lead + (E,),
                                    dtype=dtype),
        "w_up": layers.dense_init(gen, d_model, d_ff, lead=lead + (E,),
                                  dtype=dtype),
        "w_down": layers.dense_init(gen, d_ff, d_model, lead=lead + (E,),
                                    dtype=dtype),
    }
    if cfg.num_shared_experts:
        p["shared"] = layers.init_gated_mlp(
            gen, d_model, d_ff * cfg.num_shared_experts, lead=lead,
            dtype=dtype)
    if cfg.dense_residual:
        p["dense_residual"] = layers.init_gated_mlp(
            gen, d_model, cfg.d_ff_dense_residual, lead=lead, dtype=dtype)
    return p


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    c = math.ceil(cfg.top_k * tokens_per_group / cfg.num_experts
                  * cfg.capacity_factor)
    return max(c, 1)


def num_groups_for(n_tokens: int) -> int:
    """The reference's group count: about 512 tokens a group, decremented
    until it divides the token count."""
    groups = max(1, n_tokens // 512)
    while n_tokens % groups:
        groups -= 1
    return groups


def route(router: torch.Tensor, xt: torch.Tensor, cfg: MoEConfig):
    """The router over grouped tokens ``xt`` ``(G, Sg, d)``: returns
    (probs ``(G, Sg, E)`` f32, the renormalized top-k gates ``(G, Sg, K)``
    and their experts ``(G, Sg, K)``).  Ties go to the lower expert index
    first, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no
    order on ties): a stable descending sort."""
    logits = xt.float() @ router  # (G, Sg, E); the router is f32
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[..., :cfg.top_k], top_idx[..., :cfg.top_k]
    # deepseek renormalizes the selected gates
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_idx


def queue_positions(onehot: torch.Tensor) -> torch.Tensor:
    """Each (token, k)'s place in its expert's queue, ``onehot`` ``(G, Sg,
    K, E)`` -> ``(G, Sg, K)``: an exclusive cumsum over the token-major
    flattening ``(G, Sg*K, E)``, the order the reference drops in."""
    G, Sg, K, E = onehot.shape
    flat = onehot.reshape(G, Sg * K, E)
    pos_in_expert = torch.cumsum(flat, dim=1) - flat
    return torch.sum(pos_in_expert * flat, dim=-1).reshape(G, Sg, K)


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
              num_groups: Optional[int] = None):
    """Returns (out ``(B, S, d)``, aux loss ``()`` f32).  Tokens over
    capacity are dropped (the residual passes them through untouched),
    standard Switch behaviour."""
    B, S, d = x.shape
    N = B * S
    G = num_groups_for(N) if num_groups is None else num_groups
    Sg = N // G
    xt = x.reshape(G, Sg, d)
    E, K = cfg.num_experts, cfg.top_k
    C = _capacity(Sg, cfg)
    probs, top_p, top_idx = route(params["router"], xt, cfg)
    onehot = F.one_hot(top_idx, E)  # (G, Sg, K, E) int64
    pos = queue_positions(onehot)
    within_cap = pos < C

    gate = top_p * within_cap.to(top_p.dtype)  # (G, Sg, K)
    # dispatch: (G, Sg, E, C) one-hot in expert and slot
    slot_oh = F.one_hot(torch.where(within_cap, pos, C), C + 1)[..., :C].to(
        x.dtype)
    onehot_x = onehot.to(x.dtype)
    disp = torch.einsum("gske,gskc->gsec", onehot_x, slot_oh)
    comb = torch.einsum("gsk,gske,gskc->gsec", gate.to(x.dtype), onehot_x,
                        slot_oh)

    expert_in = torch.einsum("gsec,gsd->egcd", disp, xt)  # (E, G, C, d)
    h = F.silu(layers.einsum("egcd,edf->egcf", expert_in, params["w_gate"]))
    h = h * layers.einsum("egcd,edf->egcf", expert_in, params["w_up"])
    expert_out = layers.einsum("egcf,efd->egcd", h, params["w_down"])
    out = layers.einsum("gsec,egcd->gsd", comb, expert_out).reshape(B, S, d)

    if "shared" in params:
        out = out + layers.gated_mlp(params["shared"], x)
    if "dense_residual" in params:
        out = out + layers.gated_mlp(params["dense_residual"], x)

    # Switch-style load-balance auxiliary loss: the fraction of tokens
    # whose top-1 is e, against the mean router probability of e
    density = torch.mean(F.one_hot(top_idx[..., 0], E).float(), dim=(0, 1))
    router_prob = torch.mean(probs, dim=(0, 1))  # (E,)
    aux = E * torch.sum(density * router_prob) * cfg.router_aux_weight
    return out, aux


def moe_params_count(d_model: int, d_ff: int, cfg: MoEConfig) -> int:
    E = cfg.num_experts
    n = d_model * E  # router
    n += 3 * E * d_model * d_ff
    if cfg.num_shared_experts:
        n += 3 * d_model * d_ff * cfg.num_shared_experts
    if cfg.dense_residual:
        n += 3 * d_model * cfg.d_ff_dense_residual
    return n


def moe_active_params_count(d_model: int, d_ff: int, cfg: MoEConfig) -> int:
    """Active (per-token) params — used for MODEL_FLOPS = 6 * N_active * D."""
    n = d_model * cfg.num_experts  # router always runs
    n += 3 * cfg.top_k * d_model * d_ff
    if cfg.num_shared_experts:
        n += 3 * d_model * d_ff * cfg.num_shared_experts
    if cfg.dense_residual:
        n += 3 * d_model * cfg.d_ff_dense_residual
    return n
