"""Split inference serving: KV-cached decode with continuous batching.

* towers prefill their feature slices ONCE per request (``serve_prefill``
  over a transport) and keep a per-request tower KV session; role 0 merges
  the K prefill cut slices into the request's cut activation — per-session
  state held in a :class:`CutCache` with explicit byte capacity, LRU
  eviction, and admission control;
* role 0 server-prefills a decode SLOT from the cached cut and then decodes
  autoregressively: each round ships the last sampled token down and a
  (1, 1, cut) frame back up per client, keyed by ``(request, position)``
  (:class:`~repro_torch.runtime.serve_driver.ServeDriver`);
* the server decode step runs every slot together: the slot axis is the
  batch axis of one decode, each slot carrying its own ``index``, so
  requests at heterogeneous positions decode in one step, and CONTINUOUS
  batching retires finished slots and admits queued requests mid-flight
  (``continuous=False`` is the static whole-batch-drain baseline).

Idle slots "chew zeros": their index advances every round and their
output is discarded.  Past the cache end their writes clamp to the last
slot (``decode_attention_apply``), and the slot is overwritten whole at
the next admit.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch import DeviceLike, resolve_device, tree_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import compat
from repro_torch.core.protocol import Ledger
from repro_torch.models import split_program
from repro_torch.runtime.serve_driver import ServeDriver
from repro_torch.serve.decode import SamplingParams, sample_token


class CutCache:
    """Role-0 cache of per-session merged cut activations.

    Entries live from a request's prefill round until it retires (pinned
    while its decode slot is live).  Inserting past ``capacity_bytes``
    evicts the least-recently-used UNPINNED entry; a scheduled request
    whose cut was evicted is READMITTED by re-running its prefill round.
    ``can_admit`` is the admission check; a single cut larger than the
    whole capacity is rejected at submit."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        if capacity_bytes is not None and capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes must be positive or None, "
                             f"got {capacity_bytes}")
        self.capacity_bytes = capacity_bytes
        self._entries: OrderedDict = OrderedDict()  # rid -> cut (1, S, d)
        self._pinned: set = set()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "insertions": 0}

    @staticmethod
    def entry_bytes(cut: torch.Tensor) -> int:
        return cut.numel() * cut.element_size()

    @property
    def total_bytes(self) -> int:
        return sum(self.entry_bytes(c) for c in self._entries.values())

    @property
    def pinned_bytes(self) -> int:
        return sum(self.entry_bytes(c) for r, c in self._entries.items()
                   if r in self._pinned)

    def __contains__(self, rid) -> bool:
        return rid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def can_admit(self, nbytes: int) -> bool:
        """Could a ``nbytes`` cut be made resident right now (evicting
        unpinned entries if needed)?"""
        if self.capacity_bytes is None:
            return True
        return nbytes <= self.capacity_bytes - self.pinned_bytes

    def put(self, rid, cut: torch.Tensor) -> None:
        nbytes = self.entry_bytes(cut)
        if not self.can_admit(nbytes):
            raise RuntimeError(
                f"CutCache: cannot admit {nbytes} bytes for {rid!r} "
                f"(capacity {self.capacity_bytes}, pinned "
                f"{self.pinned_bytes}) — admission control should have "
                "deferred this prefill")
        self._entries.pop(rid, None)
        if self.capacity_bytes is not None:
            while self.total_bytes + nbytes > self.capacity_bytes:
                victim = next(r for r in self._entries
                              if r not in self._pinned)
                del self._entries[victim]
                self.stats["evictions"] += 1
        self._entries[rid] = cut
        self.stats["insertions"] += 1

    def get(self, rid):
        """The request's cut, or None if it was evicted (a miss)."""
        cut = self._entries.get(rid)
        if cut is None:
            self.stats["misses"] += 1
            return None
        self._entries.move_to_end(rid)
        self.stats["hits"] += 1
        return cut

    def pin(self, rid) -> None:
        self._pinned.add(rid)

    def release(self, rid) -> None:
        """Retire a session: unpin and drop its cut."""
        self._pinned.discard(rid)
        self._entries.pop(rid, None)


@dataclass
class ServeRequest:
    rid: int
    prompt: torch.Tensor  # (S,) token ids
    max_new_tokens: int
    prefilled_once: bool = False  # ahead-prefill runs at most once


@dataclass
class ServeResult:
    rid: int
    prompt_len: int
    tokens: list = field(default_factory=list)  # generated token ids (ints)


def _sample_seed(seed: int, rid: int, pos: int) -> int:
    """One generator seed per (request, position), so continuous and static
    batching sample identical streams."""
    return ((seed * 1_000_003 + rid) * 1_000_003 + pos) % (2 ** 63)


class SplitLMServer:
    """Role-0 serving driver over a transport of tower workers.

    ``submit()`` enqueues requests; ``run()`` drives prefill + continuous
    (or static) batched decode until every submitted request completes and
    returns the :class:`ServeResult` list in submission order.  The
    transport stays open — the caller owns its lifecycle.  Runs on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for), where
    ``server_params`` must already live.  ``use_kernel=False`` merges with
    the plain version (comparison runs)."""

    def __init__(self, transport, cfg: ArchConfig, server_params, *,
                 cache_len: int, max_batch: int = 4,
                 cut_cache_bytes: Optional[int] = None,
                 continuous: bool = True,
                 sampling: SamplingParams = SamplingParams(greedy=True),
                 seed: int = 0, label_holder: int = 0,
                 ledger: Optional[Ledger] = None,
                 timeout_s: float = 120.0, device: DeviceLike = None,
                 use_kernel: bool = True):
        if cfg.vertical is None:
            raise ValueError(f"{cfg.name}: split serving needs a vertical "
                             "config")
        compat.check("serve", serve=True,
                     secure=cfg.vertical.secure_aggregation,
                     compress=cfg.vertical.compression, context=cfg.name)
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        params_dev = tree_device(server_params)
        if params_dev is not None and params_dev.type != self.device.type:
            raise ValueError(f"server params are on {params_dev}, the server "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.server_params = server_params
        self.cache_len = int(cache_len)
        self.max_batch = int(max_batch)
        self.continuous = bool(continuous)
        self.sampling = sampling
        self.seed = int(seed)

        program = split_program.get_program(cfg)
        if transport.num_clients != program.num_clients:
            raise ValueError(
                f"transport has {transport.num_clients} clients, "
                f"{cfg.name} expects {program.num_clients}")
        self._fns = program.server_serve_fns()
        self.driver = ServeDriver(transport, merge=cfg.vertical.merge,
                                  label_holder=label_holder, ledger=ledger,
                                  timeout_s=timeout_s,
                                  secure=cfg.vertical.secure_aggregation,
                                  compress=cfg.vertical.compression,
                                  use_kernel=use_kernel)
        self.cut_cache = CutCache(cut_cache_bytes)

        # decode slots: the slot axis is the batch axis of one decode step,
        # each slot at its own position (per-slot cache index)
        self._slots = self._fns.init_cache(self.cache_len, self.max_batch,
                                           device=self.device)

        self._queue: list[ServeRequest] = []  # FIFO: submitted, not active
        self._results: dict = {}
        self._order: list[int] = []
        self._next_rid = 0
        self.stats = {"requests": 0, "tokens": 0, "decode_rounds": 0,
                      "prefills": 0, "reprefills": 0, "peak_active": 0}

    # -- request intake ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               rid: Optional[int] = None) -> int:
        """Enqueue one request; returns its request id."""
        prompt = torch.as_tensor(prompt, dtype=torch.long,
                                 device=self.device).reshape(-1)
        S = int(prompt.shape[0])
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if S + max_new_tokens > self.cache_len:
            raise ValueError(
                f"request needs {S} prompt + {max_new_tokens} new tokens "
                f"= {S + max_new_tokens} cache slots but cache_len is "
                f"{self.cache_len} — raise cache_len or shorten the "
                "request")
        cut_bytes = S * self.cfg.d_model * 4
        cap = self.cut_cache.capacity_bytes
        if cap is not None and cut_bytes > cap:
            raise ValueError(
                f"admission control: the request's merged cut needs "
                f"{cut_bytes} bytes but the cut cache holds "
                f"{cap} — raise cut_cache_bytes or shorten the prompt")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        self._queue.append(ServeRequest(rid=rid, prompt=prompt,
                                        max_new_tokens=int(max_new_tokens)))
        self._order.append(rid)
        self.stats["requests"] += 1
        return rid

    # -- serving loop --------------------------------------------------------

    def _prefill_request(self, req: ServeRequest, *, ahead: bool) -> None:
        """Run one request's tower prefill round and cache the merged cut."""
        merged = self.driver.prefill(req.rid, req.prompt, self.cache_len)
        self.cut_cache.put(req.rid, merged)
        self.stats["prefills"] += 1
        if req.prefilled_once and not ahead:
            self.stats["reprefills"] += 1
        req.prefilled_once = True

    def _prefill_ahead(self) -> None:
        """Tower-prefill queued requests (each at most once) while the cut
        cache admits them."""
        for req in self._queue:
            if req.prefilled_once or req.rid in self.cut_cache:
                continue
            est = int(req.prompt.shape[0]) * self.cfg.d_model * 4
            if not self.cut_cache.can_admit(est):
                break  # pinned sessions hold the space; retry after retires
            self._prefill_request(req, ahead=True)

    def _write_slot(self, new: dict, slot: int) -> None:
        """Overwrite decode slot ``slot`` with a one-slot cache, in place."""
        self._slots["k"][:, slot] = new["k"][:, 0]
        self._slots["v"][:, slot] = new["v"][:, 0]
        self._slots["kv_positions"][slot] = new["kv_positions"][0]
        self._slots["index"][slot] = new["index"][0]

    def _admit(self, req: ServeRequest, slot: int, active: dict) -> None:
        """Bind a request to a decode slot: server-prefill the slot's KV
        cache from the (re)admitted cut and sample the first token."""
        cut = self.cut_cache.get(req.rid)
        if cut is None:  # evicted while waiting: readmission path
            self._prefill_request(req, ahead=False)
            cut = self.cut_cache.get(req.rid)
        self.cut_cache.pin(req.rid)
        fresh = self._fns.init_cache(self.cache_len, 1, device=self.device)
        logits, slot_cache = self._fns.prefill(self.server_params, fresh, cut)
        self._write_slot(slot_cache, slot)
        tok = self._sample(req.rid, int(req.prompt.shape[0]), logits[0])
        active[slot] = {
            "req": req, "pos": int(req.prompt.shape[0]), "last_tok": tok,
            "tokens": [tok],
        }
        self.stats["tokens"] += 1

    def _sample(self, rid: int, pos: int, logits: torch.Tensor) -> int:
        if self.sampling.greedy:
            return int(torch.argmax(logits, dim=-1))
        gen = torch.Generator(device=logits.device).manual_seed(
            _sample_seed(self.seed, rid, pos))
        return int(sample_token(logits, self.sampling, gen))

    def _retire(self, slot: int, active: dict) -> None:
        st = active.pop(slot)
        req = st["req"]
        self.cut_cache.release(req.rid)
        self.driver.end_session(req.rid)
        self._results[req.rid] = ServeResult(
            rid=req.rid, prompt_len=int(req.prompt.shape[0]),
            tokens=st["tokens"])

    def run(self) -> list[ServeResult]:
        """Serve every submitted request to completion; returns results in
        submission order.  Continuous batching admits a queued request the
        moment a slot retires; static batching (``continuous=False``)
        drains the whole batch before admitting the next one."""
        active: dict = {}  # slot -> {"req", "pos", "last_tok", "tokens"}
        zero_cut = torch.zeros((1, 1, self.cfg.d_model), dtype=torch.float32,
                               device=self.device)
        while self._queue or active:
            # 1. admit: continuous refills any free slot; static only
            #    admits into an empty batch
            if self.continuous or not active:
                free = [s for s in range(self.max_batch) if s not in active]
                while self._queue and free:
                    req = self._queue[0]
                    if req.rid not in self.cut_cache:
                        # readmission needs cache room NOW; defer until a
                        # pinned session retires
                        est = int(req.prompt.shape[0]) * self.cfg.d_model * 4
                        if not self.cut_cache.can_admit(est):
                            break
                    self._queue.pop(0)
                    self._admit(req, free.pop(0), active)
            # 2. prefill-ahead so waiting requests admit without a tower
            #    round on the critical path
            self._prefill_ahead()
            # 3. retire requests done at admission (max_new_tokens == 1)
            for slot in list(active):
                st = active[slot]
                if len(st["tokens"]) >= st["req"].max_new_tokens:
                    self._retire(slot, active)
            if not active:
                continue
            self.stats["peak_active"] = max(self.stats["peak_active"],
                                            len(active))
            # 4. one decode round: token frames down, cut frames up, for
            #    ACTIVE slots only — then one server step over ALL slots
            entries = [(st["req"].rid, st["last_tok"], st["pos"])
                       for st in active.values()]
            merged = self.driver.decode_round(entries)
            x = torch.stack([
                merged[active[s]["req"].rid] if s in active else zero_cut
                for s in range(self.max_batch)])  # (slots, 1, 1, d)
            logits, self._slots = self._fns.decode(
                self.server_params, self._slots, x.reshape(
                    self.max_batch, 1, -1))
            self.stats["decode_rounds"] += 1
            # 5. sample, advance, retire finished slots
            for slot in list(active):
                st = active[slot]
                st["pos"] += 1
                tok = self._sample(st["req"].rid, st["pos"], logits[slot])
                st["tokens"].append(tok)
                st["last_tok"] = tok
                self.stats["tokens"] += 1
                if len(st["tokens"]) >= st["req"].max_new_tokens:
                    self._retire(slot, active)
        out = [self._results[rid] for rid in self._order
               if rid in self._results]
        self._order = [rid for rid in self._order
                       if rid not in self._results]
        self._results = {}
        return out

    # -- accounting ----------------------------------------------------------

    @property
    def ledger(self) -> Ledger:
        return self.driver.ledger

    def wire_report(self) -> dict:
        """Audited serving traffic by message class (bytes)."""
        led = self.driver.ledger
        by_kind = {"serve_prompt": 0, "serve_prefill_cut": 0,
                   "serve_token": 0, "serve_cut": 0}
        for kind in by_kind:
            by_kind[kind] = sum(
                m.num_bytes for m in led.messages
                if m.tag.startswith(kind + "["))
        tokens = max(self.stats["tokens"], 1)
        return {
            **by_kind,
            "total": sum(by_kind.values()),
            "bytes_per_token": sum(by_kind.values()) / tokens,
            "decode_bytes_per_token":
                (by_kind["serve_token"] + by_kind["serve_cut"]) / tokens,
        }
