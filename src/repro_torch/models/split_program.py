"""Per-family SplitProgram: the execution-side contract of the vertical split.

A :class:`SplitProgram` bundles what the protocol stack needs to train and
serve one config family split across the role-1/3 feature holders and the
role-0 server:

* ``tower_fwd(k)`` — client ``k``'s ``(tower_params, feats) -> cut``;
* ``server_fwd`` — the role-0 forward ``(server_params, merged) ->
  logits``, or ``(logits, aux)`` when the family carries an auxiliary
  loss (``has_aux``: the moe router's load-balance term, shipped role 0
  -> role 3 through the protocol's aux slot);
* ``loss_fn`` — the role-3 loss ``(logits, batch_ctx) -> scalar``;
* ``partition(params)`` — the per-role split of a monolithic param tree;
* ``features`` / ``feature_fn`` — the per-client feature source,
  driver-side (one batch) and worker-side (regenerated from the shared
  seed, so only protocol messages cross a transport);
* the tower / server serving bundles.

The port registers every family of the JAX package: the token-LM program
for the dense, moe, ssm and hybrid families, the audio program (mel-band
towers on the whisper encoder, ``server_takes_batch``) and the vlm
program (modality towers merged by a sequence concatenation,
``merge_fn``).

``tower_params`` gives a tower as views into the monolithic tree (a
serving worker, which never updates its weights, holds no copy);
``partition`` copies them, and so does a training worker
(``build_split_worker`` with a learning rate), because the training
loops update params in place (``AdamW(inplace=True)``), and a tower
that viewed the server's embedding table would be trained by the
server's update.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.data.loader import LMBatchLoader, to_tensor
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.backbone import (_audio_decoder_apply,
                                         _audio_encoder_tail, _server_layers,
                                         _server_trunk_apply, _ssm_towers,
                                         _tower_dims, lm_loss)
from repro_torch.models.transformer import BlockDims
from repro_torch.tree_util import tree_map


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
    """Family-agnostic contract; subclasses register one family each.

    The class-level shape flags are the JAX package's (``executor_kwargs``
    hands them to the Executor): ``server_takes_batch`` (``server_fwd``
    takes the role-0 batch context: the audio decoder's teacher-forcing
    tokens), ``has_aux`` (the moe router's aux slot) and ``merge_fn``
    (``(cuts, live_mask) -> merged`` for cuts of different shapes: the
    vlm sequence concatenation); ``per_client_towers`` says that
    ``tower_fwd(k)`` differs by client (the audio and vlm programs)."""

    server_takes_batch = False
    has_aux = False
    per_client_towers = False
    merge_fn: Optional[Callable] = None

    def __init__(self, cfg: ArchConfig):
        if cfg.vertical is None:
            raise ValueError(f"{cfg.name}: split execution needs a vertical "
                             "config")
        self.cfg = cfg
        self.merge = cfg.vertical.merge

    @property
    def num_clients(self) -> int:
        return self.cfg.vertical.num_clients

    @property
    def tower_fwds(self) -> list:
        return [self.tower_fwd(k) for k in range(self.num_clients)]

    @property
    def executor_kwargs(self) -> dict:
        """Keyword arguments configuring an Executor for this program."""
        return dict(server_takes_batch=self.server_takes_batch,
                    server_aux=self.has_aux, merge_fn=self.merge_fn)

    #: the monolithic tree's keys that the towers take, none of which the
    #: server keeps
    tower_keys: tuple = ("towers",)

    def tower_params(self, params, client: int) -> dict:
        """Client ``client``'s tower tree, as views into ``params``."""
        raise NotImplementedError

    def server_params(self, params) -> dict:
        """Role 0's tree: ``params`` without the towers' keys, holding
        ``params``' own tensors."""
        return {key: val for key, val in params.items()
                if key not in self.tower_keys}

    def partition(self, params) -> tuple[list, dict]:
        """Monolithic param tree -> (per-client tower trees, each a copy
        with storage of its own, and :meth:`server_params`)."""
        return ([tree_map(torch.clone, self.tower_params(params, k))
                 for k in range(self.num_clients)],
                self.server_params(params))

    def tower_fwd(self, client: int) -> Callable:
        """Client ``client``'s ``(tower_params, feats) -> cut``."""
        raise NotImplementedError

    def features(self, batch: dict, device: DeviceLike = None) -> list:
        """Driver-side per-client feature tensors for one loader batch (the
        serial ``protocol_step`` reference path)."""
        raise NotImplementedError

    def batch_ctx(self, batch: dict, device: DeviceLike = None):
        """Role-0/3-side per-step context (the labels as int64), sliced
        into microbatches along the leading axis."""
        return torch.as_tensor(batch["labels"], dtype=torch.long,
                               device=resolve_device(device))

    def feature_fn(self, client: int, *, batch: int, seq: int, seed: int = 0,
                   microbatches: int = 1,
                   device: DeviceLike = None) -> Callable:
        """Worker-side ``(step, mb) -> feats``, regenerated from the shared
        seed."""
        raise NotImplementedError

    def _no_serving(self):
        return NotImplementedError(
            f"{self.cfg.name}: split serving is not implemented for the "
            f"{self.cfg.family!r} family — the dense token-LM program is "
            "the serving exemplar (stateful tower decode for ssm/hybrid "
            "towers is an open item)")

    def tower_serve_fns(self, client: int, *,
                        use_kernel: bool = True) -> TowerServeFns:
        """Client ``client``'s serving bundle; families without a serving
        decomposition raise, with the JAX package's words."""
        raise self._no_serving()

    def server_serve_fns(self, *, use_kernel: bool = True) -> ServerServeFns:
        """Role 0's serving bundle; families without a serving
        decomposition raise, with the JAX package's words."""
        raise self._no_serving()

    def protocol_step(self, tower_params, server_params, features, ctx, *,
                      label_holder: int = 0, live_mask=None, ledger=None):
        """Serial reference step on this program's decomposition; returns
        (loss, tower_grads, server_grads, ledger).  Merges with the plain
        version (the ``"neutral"`` drop policy), never the kernel."""
        from repro_torch.core.protocol import protocol_step

        return protocol_step(
            self.tower_fwds, self.server_fwd, self.loss_fn, tower_params,
            server_params, features, ctx, self.merge,
            label_holder=label_holder, live_mask=live_mask, ledger=ledger,
            compress=self.cfg.vertical.compression, **self.executor_kwargs)

    def _loader_feature_fn(self, *, batch: int, seq: int, seed: int,
                           microbatches: int, extract: Callable,
                           device: DeviceLike) -> Callable:
        """Iterate the shared-seed ``LMBatchLoader`` lazily; ``extract``
        picks this client's view of each batch dict."""
        dev = resolve_device(device)
        loader_it = iter(LMBatchLoader(self.cfg, batch, seq, seed=seed))
        state = {"step": -1, "batch": None}
        mbsz = batch // microbatches

        def feature_fn(step: int, mb: int) -> torch.Tensor:
            while state["step"] < step:  # steps arrive in order
                state["batch"] = next(loader_it)
                state["step"] += 1
            return to_tensor(
                extract(state["batch"])[mb * mbsz:(mb + 1) * mbsz], dev)

        return feature_fn


class TokenLMSplitProgram(SplitProgram):
    """Feature-slice towers over a shared token stream.

    Every client holds the shared token ids; its PRIVATE dimension is its
    vertical slice of the embedding table (columns [k*d/K, (k+1)*d/K)).
    The role-0 server keeps the trunk, the final norm, and the full table
    for the unembed head.

    The towers are dense blocks for the dense and moe families and Mamba2
    blocks of width ``proj_in.shape[1]`` (d_model / K) for the ssm and
    hybrid families, whose server trunks are the Mamba2 stack and the
    hybrid stack (``backbone._server_trunk_apply``).  For moe the experts
    live at role 0 and ``server_fwd`` returns ``(logits, aux)``: the
    router's load-balance loss rides the protocol's role-0 -> role-3 aux
    slot.

    Serving (dense only, as in the JAX package) is the split of the
    monolithic prefill / decode along the cut: the tower half
    (embedding-column slice -> proj_in -> tower blocks -> proj_out, with
    the tower KV cache) runs at the client; the server half (server stack
    -> final norm -> unembed, with the server KV cache) runs at role 0
    from the MERGED cut.  Training runs the same split through
    full-sequence forwards with no cache."""

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        self.has_aux = cfg.family == "moe"

    def tower_params(self, params, client: int) -> dict:
        """Client ``client``'s tower tree: views of its layer of the tower
        stacks and of its columns of the embedding table (a copy of them
        trains apart from the server's table, as in the JAX package)."""
        ds = self.cfg.d_model // self.num_clients
        tp = tfm.layer_params(params["towers"], client)
        tp["embed_slice"] = params["embed"]["table"][
            :, client * ds:(client + 1) * ds]
        return tp

    def tower_fwd(self, client: int) -> Callable:
        cfg = self.cfg
        dims_t = None if _ssm_towers(cfg) else _tower_dims(cfg)

        def tower_fwd(tp, tokens):
            x = tp["embed_slice"][tokens.long()]  # (B, S, d/K)
            h = layers.matmul(x, tp["proj_in"])
            if dims_t is None:
                h = tfm.mamba_stack_apply(tp["blocks"], h, cfg.ssm,
                                          tp["proj_in"].shape[1],
                                          cfg.norm_eps)
            else:
                positions = torch.arange(tokens.shape[-1],
                                         device=tokens.device)
                h = tfm.dense_stack_apply(tp["blocks"], h, dims_t,
                                          causal=True, positions=positions)
            return layers.matmul(h, tp["proj_out"])

        return tower_fwd

    def server_fwd(self, sp, merged):
        dims = BlockDims.from_arch(self.cfg)
        positions = torch.arange(merged.shape[1], device=merged.device)
        x, aux = _server_trunk_apply(sp, merged, self.cfg, dims,
                                     positions=positions)
        x = layers.rmsnorm(sp["final_norm"], x, dims.norm_eps)
        logits = layers.unembed(sp["embed"], x)
        if self.has_aux:
            return logits, aux
        return logits

    def loss_fn(self, logits, labels):
        return lm_loss(logits, labels)

    def features(self, batch, device=None):
        tokens = torch.as_tensor(batch["tokens"], dtype=torch.long,
                                 device=resolve_device(device))
        return [tokens] * self.num_clients

    def feature_fn(self, client, *, batch, seq, seed=0, microbatches=1,
                   device=None):
        return self._loader_feature_fn(
            batch=batch, seq=seq, seed=seed, microbatches=microbatches,
            extract=lambda b: b["tokens"], device=device)

    def _require_dense_serving(self):
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"{self.cfg.name}: split serving is implemented for the "
                f"dense token-LM family only (got {self.cfg.family!r}) — "
                "stateful ssm/hybrid tower sessions and slot-aware moe "
                "expert caches are open items")

    def tower_serve_fns(self, client: int, *,
                        use_kernel: bool = True) -> TowerServeFns:
        """``use_kernel=False`` runs the prefill's long attention on the
        plain chunked path (comparison runs)."""
        self._require_dense_serving()
        dims_t = _tower_dims(self.cfg)

        def prefill(tp, tokens, cache_len):
            S = tokens.shape[1]
            dev = tokens.device
            positions = torch.arange(S, device=dev)
            h = tp["embed_slice"][tokens] @ tp["proj_in"]  # (1, S, d_t)
            h, ks, vs = tfm.dense_stack_prefill(tp["blocks"], h, dims_t,
                                                positions=positions,
                                                use_kernel=use_kernel)
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
            h, nk, nv, npos, _ = tfm.dense_stack_decode(
                tp["blocks"], h, session["k"], session["v"],
                session["index"], session["kv_positions"], dims_t,
                position=session["index"])
            cut = h @ tp["proj_out"]
            new = {"k": nk, "v": nv, "kv_positions": npos,
                   "index": session["index"] + 1}
            return cut, new

        return TowerServeFns(prefill=prefill, decode=decode)

    def server_serve_fns(self, *, use_kernel: bool = True) -> ServerServeFns:
        """``use_kernel=False`` runs the prefill's long attention on the
        plain chunked path (comparison runs)."""
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
                                                positions=positions,
                                                use_kernel=use_kernel)
            cache["k"][:, :, :S] = ks.to(cache["k"].dtype)
            cache["v"][:, :, :S] = vs.to(cache["v"].dtype)
            cache["kv_positions"][:, :S] = positions
            cache["index"].fill_(S)
            x = layers.rmsnorm(sp["final_norm"], x, dims.norm_eps)
            logits = layers.unembed(sp["embed"], x[:, -1, :])
            return logits, cache

        def decode(sp, cache, merged):
            x, nk, nv, npos, _ = tfm.dense_stack_decode(
                sp["server"], merged, cache["k"], cache["v"], cache["index"],
                cache["kv_positions"], dims, position=cache["index"])
            new = {"k": nk, "v": nv, "kv_positions": npos,
                   "index": cache["index"] + 1}
            x = layers.rmsnorm(sp["final_norm"], x, dims.norm_eps)
            logits = layers.unembed(sp["embed"], x)[:, 0, :]
            return logits, new

        return ServerServeFns(init_cache=init_cache, prefill=prefill,
                              decode=decode)


class AudioSplitProgram(SplitProgram):
    """Whisper-style encoder split: client ``k`` holds mel-band group ``k``
    (the feature slice ``frames[..., k*d/K:(k+1)*d/K]``) and runs its
    non-causal tower over it; the merged cut feeds the server's remaining
    encoder layers, and the decoder teacher-forces over the token stream
    held at role 0/3 (``server_takes_batch``)."""

    server_takes_batch = True
    per_client_towers = True

    def tower_params(self, params, client: int) -> dict:
        return tfm.layer_params(params["towers"], client)

    def tower_fwd(self, client: int) -> Callable:
        cfg = self.cfg
        dims_t = _tower_dims(cfg)
        ds = cfg.d_model // self.num_clients
        lo = client * ds

        def tower_fwd(tp, frame_slice):
            S = frame_slice.shape[1]
            # the sinusoid is public: each client adds ITS columns of the
            # full-width one, as encode_audio adds it before the split
            pos = layers.sinusoidal_positions(S, cfg.d_model,
                                              frame_slice.dtype,
                                              device=frame_slice.device)
            h = frame_slice + pos[None, :, lo:lo + ds]
            positions = torch.arange(S, device=frame_slice.device)
            h = layers.matmul(h, tp["proj_in"])
            h = tfm.dense_stack_apply(tp["blocks"], h, dims_t, causal=False,
                                      positions=positions)
            return layers.matmul(h, tp["proj_out"])

        return tower_fwd

    def server_fwd(self, sp, merged, batch):
        dims = BlockDims.from_arch(self.cfg)
        enc_out = _audio_encoder_tail(sp, merged, self.cfg, dims)
        return _audio_decoder_apply(sp, batch["tokens"], enc_out, self.cfg,
                                    dims)

    def loss_fn(self, logits, batch):
        return lm_loss(logits, batch["labels"])

    def batch_ctx(self, batch, device=None):
        dev = resolve_device(device)
        return {"tokens": to_tensor(batch["tokens"], dev),
                "labels": to_tensor(batch["labels"], dev)}

    def features(self, batch, device=None):
        frames = to_tensor(batch["frames"], resolve_device(device))
        return list(torch.chunk(frames, self.num_clients, dim=-1))

    def feature_fn(self, client, *, batch, seq, seed=0, microbatches=1,
                   device=None):
        ds = self.cfg.d_model // self.num_clients
        lo = client * ds
        return self._loader_feature_fn(
            batch=batch, seq=seq, seed=seed, microbatches=microbatches,
            extract=lambda b: b["frames"][..., lo:lo + ds], device=device)


class VLMSplitProgram(SplitProgram):
    """The by-source split: client 0 holds the vision patches (its tower is
    the vision stack, non-causal), client 1 the text stream (its tower is
    the text stack over its own copy of the input embedding table, causal,
    at positions ``Sv + arange(S)``).  The merge is the SEQUENCE
    concatenation [vision; text]: the cuts differ in length, so the
    program supplies ``merge_fn``, and a dropped modality zeroes its
    segment (the monolithic ``live_mask``).  The server unembeds the text
    positions only.

    The JAX package's text tower holds the whole embedding dict; the
    port's holds the input table alone (the tower never reads the untied
    ``unembed``, whose update there is weight decay of an unused copy),
    which at internvl2-26b's width saves 2.3 GB of f32 params and twice
    that in moments."""

    tower_keys = ("vision_tower", "text_tower")
    per_client_towers = True

    def __init__(self, cfg: ArchConfig):
        super().__init__(cfg)
        if cfg.vertical.num_clients != 2:
            raise ValueError("the vlm by-source split has exactly two "
                             f"clients (vision, text); got "
                             f"{cfg.vertical.num_clients}")
        self.merge_fn = self._merge_seqcat

    @staticmethod
    def _merge_seqcat(cuts, live_mask=None):
        if live_mask is not None:
            cuts = [c * torch.as_tensor(live_mask, device=c.device)[k].to(
                c.dtype) for k, c in enumerate(cuts)]
        return torch.cat(list(cuts), dim=1)

    def tower_params(self, params, client: int) -> dict:
        if client == 0:
            return {"blocks": params["vision_tower"]}
        return {"embed": {"table": params["embed"]["table"]},
                "blocks": params["text_tower"]}

    def tower_fwd(self, client: int) -> Callable:
        cfg = self.cfg
        dims = BlockDims.from_arch(cfg)
        Sv = cfg.vlm.num_vision_tokens

        if client == 0:
            def vision_fwd(tp, patches):
                x = patches.to(tfm.stack_dtype(tp["blocks"]))
                positions = torch.arange(Sv, device=x.device)
                return tfm.dense_stack_apply(tp["blocks"], x, dims,
                                             causal=False,
                                             positions=positions)

            return vision_fwd

        def text_fwd(tp, tokens):
            x = layers.embed(tp["embed"], tokens.long())
            positions = Sv + torch.arange(tokens.shape[-1],
                                          device=tokens.device)
            return tfm.dense_stack_apply(tp["blocks"], x, dims, causal=True,
                                         positions=positions)

        return text_fwd

    def server_fwd(self, sp, merged):
        dims = BlockDims.from_arch(self.cfg)
        positions = torch.arange(merged.shape[1], device=merged.device)
        x = tfm.dense_stack_apply(sp["server"], merged, dims, causal=True,
                                  positions=positions)
        x = tfm.norm(sp["final_norm"], x, dims.norm, dims.norm_eps)
        return layers.unembed(sp["embed"],
                              x[:, self.cfg.vlm.num_vision_tokens:, :])

    def loss_fn(self, logits, labels):
        return lm_loss(logits, labels)

    def features(self, batch, device=None):
        dev = resolve_device(device)
        return [to_tensor(batch["patches"], dev),
                to_tensor(batch["tokens"], dev)]

    def feature_fn(self, client, *, batch, seq, seed=0, microbatches=1,
                   device=None):
        key = "patches" if client == 0 else "tokens"
        return self._loader_feature_fn(
            batch=batch, seq=seq, seed=seed, microbatches=microbatches,
            extract=lambda b: b[key], device=device)


_PROGRAMS: dict[str, type] = {"dense": TokenLMSplitProgram,
                               "moe": TokenLMSplitProgram,
                               "ssm": TokenLMSplitProgram,
                               "hybrid": TokenLMSplitProgram,
                               "audio": AudioSplitProgram,
                               "vlm": VLMSplitProgram}

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
