"""Per-family SplitProgram: the execution-side contract of the vertical split.

This slice carries the serving half of the dense token-LM program: the
per-role parameter ``partition`` and the tower / server serving bundles.
The training contract (``tower_fwd``, ``server_fwd``, ``loss_fn``, feature
sources) and the other families come with later slices.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.backbone import _server_layers, _tower_dims
from repro_torch.models.transformer import BlockDims


class TowerServeFns:
    """Client-side serving bundle: per-request tower prefill/decode.

    ``prefill(tower_params, tokens (1, S), cache_len) -> (cut (1, S, D),
    session)`` runs the tower teacher-forced over the prompt and returns
    the full-prompt cut slice plus the request's tower KV session;
    ``decode(tower_params, session, token (1,)) -> (cut (1, 1, D),
    session)`` advances the session one token."""

    def __init__(self, prefill: Callable, decode: Callable):
        self.prefill = prefill
        self.decode = decode


class ServerServeFns:
    """Role-0 serving bundle: slot caches and prefill/decode from MERGED
    cuts.

    ``init_cache(cache_len, batch=1)`` builds ``batch`` empty decode slots
    (k/v ``(L, batch, cache_len, Kv, hd)``, ``kv_positions`` ``(batch,
    cache_len)`` at -1, ``index`` ``(batch,)``); ``prefill(server_params,
    cache, merged (1, S, d)) -> (logits (1, V), cache)`` fills a one-slot
    cache from a session's merged prefill cut; ``decode(server_params,
    cache, merged (B, 1, d)) -> (logits (B, V), cache)`` advances every
    slot one token, each at its own ``index``."""

    def __init__(self, init_cache: Callable, prefill: Callable,
                 decode: Callable):
        self.init_cache = init_cache
        self.prefill = prefill
        self.decode = decode


class SplitProgram:
    """Family-agnostic contract; subclasses register one family each."""

    def __init__(self, cfg: ArchConfig):
        if cfg.vertical is None:
            raise ValueError(f"{cfg.name}: split execution needs a vertical "
                             "config")
        self.cfg = cfg
        self.merge = cfg.vertical.merge

    @property
    def num_clients(self) -> int:
        return self.cfg.vertical.num_clients

    def partition(self, params) -> tuple[list, dict]:
        """Monolithic param tree -> (per-client tower trees, server tree)."""
        raise NotImplementedError

    def tower_serve_fns(self, client: int) -> TowerServeFns:
        raise NotImplementedError

    def server_serve_fns(self) -> ServerServeFns:
        raise NotImplementedError


class TokenLMSplitProgram(SplitProgram):
    """Feature-slice towers over a shared token stream.

    Every client holds the shared token ids; its PRIVATE dimension is its
    vertical slice of the embedding table (columns [k*d/K, (k+1)*d/K)).
    The role-0 server keeps the trunk, the final norm, and the full table
    for the unembed head.

    Serving is the split of the monolithic prefill / decode along the cut:
    the tower half (embedding-column slice -> proj_in -> tower blocks ->
    proj_out, with the tower KV cache) runs at the client; the server half
    (server stack -> final norm -> unembed, with the server KV cache) runs
    at role 0 from the MERGED cut."""

    def partition(self, params):
        K = self.num_clients
        ds = self.cfg.d_model // K
        table = params["embed"]["table"]
        towers = []
        for k in range(K):
            tp = tfm.layer_params(params["towers"], k)
            # the client's own copy of its columns, not a view of the table
            tp["embed_slice"] = table[:, k * ds:(k + 1) * ds].contiguous()
            towers.append(tp)
        server = {key: val for key, val in params.items() if key != "towers"}
        return towers, server

    def _require_dense_serving(self):
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"{self.cfg.name}: split serving is implemented for the "
                f"dense token-LM family only (got {self.cfg.family!r})")

    def tower_serve_fns(self, client: int) -> TowerServeFns:
        self._require_dense_serving()
        dims_t = _tower_dims(self.cfg)

        def prefill(tp, tokens, cache_len):
            S = tokens.shape[1]
            dev = tokens.device
            positions = torch.arange(S, device=dev)
            h = tp["embed_slice"][tokens] @ tp["proj_in"]  # (1, S, d_t)
            h, ks, vs = tfm.dense_stack_prefill(tp["blocks"], h, dims_t,
                                                positions=positions)
            cut = h @ tp["proj_out"]
            Lt, B, _, Kv, hd = ks.shape
            k = ks.new_zeros((Lt, B, cache_len, Kv, hd))
            v = vs.new_zeros((Lt, B, cache_len, Kv, hd))
            k[:, :, :S] = ks
            v[:, :, :S] = vs
            kv_positions = torch.full((B, cache_len), -1, dtype=torch.long,
                                      device=dev)
            kv_positions[:, :S] = positions
            session = {"k": k, "v": v, "kv_positions": kv_positions,
                       "index": torch.full((B,), S, dtype=torch.long,
                                           device=dev)}
            return cut, session

        def decode(tp, session, token):
            h = tp["embed_slice"][token[:, None]] @ tp["proj_in"]  # (1,1,·)
            h, nk, nv, npos = tfm.dense_stack_decode(
                tp["blocks"], h, session["k"], session["v"],
                session["index"], session["kv_positions"], dims_t,
                position=session["index"])
            cut = h @ tp["proj_out"]
            new = {"k": nk, "v": nv, "kv_positions": npos,
                   "index": session["index"] + 1}
            return cut, new

        return TowerServeFns(prefill=prefill, decode=decode)

    def server_serve_fns(self) -> ServerServeFns:
        self._require_dense_serving()
        dims = BlockDims.from_arch(self.cfg)
        n_server = _server_layers(self.cfg)

        def init_cache(cache_len, batch=1, device=None):
            kv = (n_server, batch, cache_len, dims.n_kv_heads, dims.head_dim)
            return {
                "k": torch.zeros(kv, dtype=torch.float32, device=device),
                "v": torch.zeros(kv, dtype=torch.float32, device=device),
                "kv_positions": torch.full((batch, cache_len), -1,
                                           dtype=torch.long, device=device),
                "index": torch.zeros((batch,), dtype=torch.long,
                                     device=device),
            }

        def prefill(sp, cache, merged):
            S = merged.shape[1]
            positions = torch.arange(S, device=merged.device)
            x, ks, vs = tfm.dense_stack_prefill(sp["server"], merged, dims,
                                                positions=positions)
            cache["k"][:, :, :S] = ks.to(cache["k"].dtype)
            cache["v"][:, :, :S] = vs.to(cache["v"].dtype)
            cache["kv_positions"][:, :S] = positions
            cache["index"].fill_(S)
            x = layers.rmsnorm(sp["final_norm"], x, dims.norm_eps)
            logits = layers.unembed(sp["embed"], x[:, -1, :])
            return logits, cache

        def decode(sp, cache, merged):
            x, nk, nv, npos = tfm.dense_stack_decode(
                sp["server"], merged, cache["k"], cache["v"], cache["index"],
                cache["kv_positions"], dims, position=cache["index"])
            new = {"k": nk, "v": nv, "kv_positions": npos,
                   "index": cache["index"] + 1}
            x = layers.rmsnorm(sp["final_norm"], x, dims.norm_eps)
            logits = layers.unembed(sp["embed"], x)[:, 0, :]
            return logits, new

        return ServerServeFns(init_cache=init_cache, prefill=prefill,
                              decode=decode)


_PROGRAMS: dict[str, type] = {"dense": TokenLMSplitProgram}

SPLIT_EXEC_FAMILIES = tuple(_PROGRAMS)


def get_program(cfg: ArchConfig) -> SplitProgram:
    """The registered :class:`SplitProgram` for ``cfg``'s family."""
    if cfg.vertical is None:
        raise ValueError(f"{cfg.name}: split execution needs a vertical "
                         "config")
    try:
        cls = _PROGRAMS[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"no SplitProgram registered for family {cfg.family!r} "
            f"(known: {SPLIT_EXEC_FAMILIES})") from None
    return cls(cfg)
