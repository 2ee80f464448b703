"""Microbatch-pipelined split-training engine over a discrete-event clock
(the port's copy of the JAX package's simulation layer; pure timing on
the host, no tensors, except :func:`pipelined_step`).

Execution model (one training step, M microbatches, K clients):

* every client streams tower forwards for microbatches 0..M-1 on its own
  CPU resource and ships each cut activation over its own uplink;
* the role-0 server merges a microbatch as soon as its cuts are in
  (the merge kernels on the card), runs the
  server network forward, exchanges the head output/jacobian with role 3,
  backprops, and returns per-client cut jacobians on the downlinks;
* clients backprop their towers as jacobians arrive, interleaved with
  later forwards on the same CPU resource.

Modes:

* ``"pipelined"`` — staleness 0: the server waits for all K cuts of a
  microbatch.  Gradients are identical to the serial ``protocol_step``
  (asserted in tests/test_torch_nowait.py); only the clock differs.
* ``"nowait"`` — bounded staleness: the server starts a microbatch at
  ``deadline_s`` after its first cut arrives; late clients are imputed
  from their EMA (repro_torch.core.straggler) and skip that microbatch's
  jacobian, so a straggler can never stall the step.

The message schedule is THE schedule from repro_torch.core.protocol
(``step_schedule``) — serial and pipelined paths share it and the same
:class:`~repro_torch.core.protocol.Ledger`.  The reports equal the JAX
package's exactly, field by field (``tests/test_torch_runtime_sim.py``):
the heap keeps its (time, insertion-order) ties and every duration is
the same float arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch import DeviceLike, resolve_device, tree_device
from repro_torch.configs.vertical_mlp import MLPSplitConfig
from repro_torch.core import compat
from repro_torch.core.costs import mlp_forward_flops, wire_bytes
from repro_torch.core.merge import collective_bytes_per_merge, merged_dim
from repro_torch.core.protocol import Ledger
from repro_torch.runtime.clock import EventClock, Resource
from repro_torch.runtime.deadline import AdaptiveDeadline
from repro_torch.runtime.links import LinkModel

MODES = ("serial", "pipelined", "nowait")


# ---------------------------------------------------------------------------
# step plan: how much work/traffic one microbatch contains
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StepPlan:
    """Per-microbatch work and traffic; pure counts, no rates (rates live in
    :class:`~repro_torch.runtime.links.LinkModel` so one plan can be simulated
    under many network scenarios)."""

    num_clients: int
    microbatches: int
    tower_fwd_flops: tuple[float, ...]  # per client, per microbatch
    tower_bwd_flops: tuple[float, ...]
    server_flops: float  # merge + server fwd + bwd, per microbatch
    cut_bytes: int  # per client, per microbatch
    head_bytes: int  # per direction, per microbatch
    merge: str = "avg"
    cut_elements: int = 0  # per client per microbatch (for collective model)
    bytes_per_elt: int = 4
    label_holder: int = 0
    # secure aggregation: bytes of ONE public key-exchange group element
    # (costs.key_exchange_bytes); > 0 clocks the one-time setup round —
    # every client uplinks its public value, role 0 relays the K-entry
    # directory back down, and only then do the step-0 forwards start
    keyx_bytes: int = 0
    # cut compression scheme ("topk" | "int8" | None): already folded into
    # cut_bytes (costs.wire_bytes), recorded here so reports name the codec
    compress: Optional[str] = None
    # aggregation-tree fanout F (runtime.topology.AggTree) or None for the
    # star: the simulators clock relay partial-sum merges on the relays'
    # CPUs and serialize only the min(F, K) top-level frames through
    # role 0's NIC and merge path — the per-level link structure of
    # StepPlan under a tree
    tree_fanout: Optional[int] = None


def _keyx_bytes(secure: bool) -> int:
    if not secure:
        return 0
    from repro_torch.core.secure_agg import KEYX_GROUP_BYTES

    return KEYX_GROUP_BYTES


def _check_tree_plan(tree_fanout: Optional[int], merge: str,
                     compress: Optional[str]) -> None:
    if tree_fanout is None:
        return
    compat.check("engine", tree=tree_fanout, merge=merge, compress=compress)
    if tree_fanout < 2:
        raise ValueError(f"tree_fanout must be >= 2, got {tree_fanout}")


def plan_step(cfg: MLPSplitConfig, batch_size: int, microbatches: int = 1,
              *, bytes_per_elt: int = 4, secure: bool = False,
              compress: Optional[str] = None,
              topk_fraction: float = 0.25,
              tree_fanout: Optional[int] = None) -> StepPlan:
    """Build a :class:`StepPlan` from the paper-MLP config using the same
    analytic FLOP model as repro_torch.core.costs (Tables 5 & 6).  ``compress``
    prices the cut uplinks AND jacobian downlinks (both clock
    ``plan.cut_bytes``) at the codec's wire frame via ``costs.wire_bytes``.
    ``tree_fanout`` plans a fanout-F aggregation tree (additive merges
    only; mirrors the Executor's constructor rejections)."""
    compat.check("engine", secure=secure, compress=compress)
    _check_tree_plan(tree_fanout, cfg.merge, compress)
    if batch_size % microbatches:
        raise ValueError(f"batch {batch_size} not divisible by M={microbatches}")
    mb = batch_size // microbatches
    fwd = tuple(
        float(mlp_forward_flops([fs, *cfg.tower_hidden, cfg.cut_dim], mb))
        for fs in cfg.client_feature_sizes
    )
    server_in = merged_dim(cfg.merge, cfg.cut_dim, cfg.num_clients)
    server_fwd = mlp_forward_flops(
        [server_in, *cfg.server_hidden, cfg.num_classes], mb
    )
    return StepPlan(
        num_clients=cfg.num_clients,
        microbatches=microbatches,
        tower_fwd_flops=fwd,
        tower_bwd_flops=tuple(2.0 * f for f in fwd),  # dL/dx + dL/dW
        server_flops=3.0 * server_fwd,
        cut_bytes=wire_bytes((mb, cfg.cut_dim), bytes_per_elt, compress,
                             topk_fraction),
        head_bytes=mb * cfg.num_classes * bytes_per_elt,
        merge=cfg.merge,
        cut_elements=mb * cfg.cut_dim,
        bytes_per_elt=bytes_per_elt,
        keyx_bytes=_keyx_bytes(secure),
        compress=compress,
        tree_fanout=tree_fanout,
    )


_FROM_CFG = object()  # sentinel: read the value off cfg.vertical


def plan_from_arch(cfg, batch_size: int, seq_len: int, microbatches: int = 1,
                   *, bytes_per_elt: int = 4,
                   secure: Optional[bool] = None,
                   compress=_FROM_CFG,
                   topk_fraction: Optional[float] = None,
                   tree_fanout: Optional[int] = None) -> StepPlan:
    """StepPlan for a vertically-split LM arch
    (:class:`repro_torch.configs.base.ArchConfig`).

    Towers are ``tower_layers`` transformer blocks at width d_model/K; the
    cut activation is (tokens, d_model/K).  Per-layer FLOPs/token use the
    standard 2*(4 d^2 + 2 d d_ff) dense estimate.  The role-3 exchange is
    modeled at per-token-loss granularity (not full-vocab logits): the
    label holder returns loss jacobian summaries, labels ship out of band.
    ``secure=None`` reads ``cfg.vertical.secure_aggregation``; ``compress``
    and ``topk_fraction`` default to ``cfg.vertical.compression`` /
    ``cfg.vertical.topk_fraction`` and price BOTH cut directions at the
    codec's wire frame.
    """
    v = cfg.vertical
    if v is None:
        raise ValueError(f"{cfg.name} has no vertical config")
    if secure is None:
        secure = v.secure_aggregation
    if compress is _FROM_CFG:
        compress = v.compression
    if topk_fraction is None:
        topk_fraction = v.topk_fraction
    compat.check("engine", secure=secure, compress=compress)
    _check_tree_plan(tree_fanout, v.merge, compress)
    if batch_size % microbatches:
        raise ValueError(f"batch {batch_size} not divisible by M={microbatches}")
    K = v.num_clients
    tokens = (batch_size // microbatches) * seq_len
    d_t, ff_t = cfg.d_model // K, (cfg.d_ff or cfg.d_model * 4) // K

    def block_flops(d, ff):
        return 2 * (4 * d * d + 2 * d * ff)

    tower = float(v.tower_layers * block_flops(d_t, ff_t) * tokens)
    server_layers = max(cfg.num_layers - v.tower_layers, 1)
    server_fwd = (
        server_layers * block_flops(cfg.d_model, cfg.d_ff or cfg.d_model * 4)
        + 2 * cfg.d_model * cfg.vocab_size
    ) * tokens
    return StepPlan(
        num_clients=K,
        microbatches=microbatches,
        tower_fwd_flops=(tower,) * K,
        tower_bwd_flops=(2.0 * tower,) * K,
        server_flops=3.0 * server_fwd,
        cut_bytes=wire_bytes((tokens, d_t), bytes_per_elt, compress,
                             topk_fraction),
        head_bytes=tokens * bytes_per_elt,
        merge=v.merge,
        cut_elements=tokens * d_t,
        bytes_per_elt=bytes_per_elt,
        keyx_bytes=_keyx_bytes(secure),
        compress=compress,
        tree_fanout=tree_fanout,
    )


def default_deadline_s(plan: StepPlan, link: LinkModel) -> float:
    """No-wait grace window after the first cut arrives: as long again as
    the fastest client's forward+uplink path.  Healthy peers make it; a
    multiple-x straggler misses and gets imputed."""
    return min(
        link.client_compute_s(k, plan.tower_fwd_flops[k])
        + link.transfer_s(k, plan.cut_bytes)
        for k in range(plan.num_clients)
    )


# ---------------------------------------------------------------------------
# simulation
# ---------------------------------------------------------------------------

@dataclass
class SimReport:
    mode: str
    step_time_s: float  # per-step (the S-step makespan / steps)
    microbatches: int
    live: list[list[float]]  # (S*M, K) — 1.0 = client's cut made the merge
    misses_per_client: list[int]
    cut_bytes_per_client: int  # uplink bytes per client, all steps
    collective_bytes_per_client: int  # analytic all-reduce/all-gather model
    server_busy_s: float = 0.0
    steps: int = 1
    cross_step: int = 1  # driver window W (staleness = W - 1)
    total_time_s: float = 0.0  # S-step makespan

    @property
    def total_misses(self) -> int:
        return sum(self.misses_per_client)


def _report_skeleton(plan: StepPlan, mode: str, steps: int = 1,
                     cross_step: int = 1) -> SimReport:
    M, K = plan.microbatches, plan.num_clients
    return SimReport(
        mode=mode,
        step_time_s=0.0,
        microbatches=M,
        live=[[1.0] * K for _ in range(steps * M)],
        misses_per_client=[0] * K,
        cut_bytes_per_client=plan.cut_bytes * M * steps,
        collective_bytes_per_client=steps * M * collective_bytes_per_merge(
            plan.merge, plan.cut_elements, K, plan.bytes_per_elt
        ),
        steps=steps,
        cross_step=cross_step,
    )


def simulate_serial(plan: StepPlan, link: LinkModel, *,
                    steps: int = 1) -> SimReport:
    """Clock the serial ``protocol_step`` schedule: every phase completes
    before the next begins, clients one after another, full batch at once
    (so per-microbatch quantities scale by M but each link pays its latency
    once per message, not once per microbatch).  Steps never overlap, so
    ``steps`` just scales the makespan — except the secure-aggregation key
    exchange (``plan.keyx_bytes`` > 0), a ONE-TIME setup round paid before
    step 0 and amortized into ``step_time_s`` over ``steps``.

    A ``plan.tree_fanout`` adds the tree's terms — relay receive hops and
    partial-sum adds on the way up, relay forward hops on the way down —
    while role 0's NIC (``link.server_bandwidth_bps``) serializes only the
    ``min(F, K)`` top-level frames.  Everything is sequential here, so the
    serial clock shows NO tree win (strictly more hops): the win is the
    reduced role-0 serialization, which only the pipelined clock can see.
    """
    M, K = plan.microbatches, plan.num_clients
    tree = None
    if plan.tree_fanout:
        from repro_torch.runtime.topology import AggTree

        tree = AggTree(K, plan.tree_fanout)
    n_top = len(tree.top_level) if tree is not None else K
    setup = 0.0
    if plan.keyx_bytes:
        # serial key exchange: role 0 gathers every public value, then
        # relays the K-entry directory down each link, one after another
        for k in range(K):
            setup += link.transfer_s(k, plan.keyx_bytes)
        for k in range(K):
            setup += link.transfer_s(k, K * plan.keyx_bytes)
    t = 0.0
    for k in range(K):
        t += link.client_compute_s(k, plan.tower_fwd_flops[k] * M)
    for k in range(K):
        t += link.transfer_s(k, plan.cut_bytes * M)
    if tree is not None:
        for k in range(K):
            p = tree.parent(k)
            if p is not None:
                # child frame crosses the relay's downlink too, and the
                # relay pays one add per child element before uplinking
                t += link.transfer_s(p, plan.cut_bytes * M)
        for r in tree.relays:
            t += link.client_compute_s(
                r, len(tree.children(r)) * plan.cut_elements * M)
    t += link.server_transfer_s(n_top * plan.cut_bytes * M)  # role-0 NIC rx
    t += link.server_compute_s(plan.server_flops * M)
    t += 2 * link.transfer_s(plan.label_holder, plan.head_bytes * M)
    t += link.server_transfer_s(n_top * plan.cut_bytes * M)  # role-0 NIC tx
    for k in range(K):
        t += link.transfer_s(k, plan.cut_bytes * M)
        t += link.client_compute_s(k, plan.tower_bwd_flops[k] * M)
    if tree is not None:
        # jacobian fan-down: a relay forwards the shared jacobian to each
        # child over its own uplink (the child's downlink is already paid
        # in the per-client loop above)
        for k in range(K):
            p = tree.parent(k)
            if p is not None:
                t += link.transfer_s(p, plan.cut_bytes * M)
    report = _report_skeleton(plan, "serial", steps)
    report.total_time_s = t * steps + setup
    report.step_time_s = report.total_time_s / steps
    report.server_busy_s = link.server_compute_s(plan.server_flops * M) * steps
    return report


def simulate_pipelined(
    plan: StepPlan,
    link: LinkModel,
    *,
    mode: str = "pipelined",
    deadline_s: Optional[float] = None,
    deadline: Optional[AdaptiveDeadline] = None,
    steps: int = 1,
    cross_step: int = 1,
) -> SimReport:
    """Event-driven makespan of the overlapped schedule; see module doc.

    ``steps`` clocks a run of S training steps; ``cross_step`` is the
    driver's in-flight window W (``runtime.pipeline.StepPipeline``): the
    driver submits step s only once step s-W has fully collected, so at
    W=1 consecutive steps barrier exactly like ``Executor.run_step`` while
    at W>1 step t+1's tower forwards run against step t's server
    compute/jacobian drain.  Driver ordering is modeled faithfully,
    including the client FIFO: ``submit_step`` ships ALL M of a step's
    forwards upfront, so every released forward is already queued on the
    client CPU before any same-window backward arrives — the simulator
    acquires all M forward slots at release time (``Resource`` grants in
    acquire-call order) rather than chaining microbatch m+1 at the end of
    m, so a step-t backward correctly queues BEHIND step-t+1's
    already-submitted forwards instead of slotting between them.  The
    role-0 server merges step t+1 microbatches only after step t's
    ``step_done`` barrier (client tower backwards + an ack latency), and
    every cut-class frame role 0 receives/sends additionally serializes on
    its NIC at ``link.server_bandwidth_bps`` (infinite by default — zero
    width, pre-existing predictions unchanged).

    A ``plan.tree_fanout`` clocks the fanout-F aggregation tree: each
    client's forward feeds its subtree's partial-sum accumulator; a relay
    merges once its own cut and every child's combined frame landed
    (child hop = child uplink -> relay downlink; the adds run on the
    relay's CPU, contending with its forwards/backwards) and uplinks ONE
    frame; role 0 barriers on the ``min(F, K)`` top-level frames and fans
    ONE jacobian per top-level client back, which relays forward to their
    children after their own tower backward.  Role 0's NIC and merge path
    see O(F) frames per microbatch — the crossover against the star's
    O(K) is exactly what the K-sweep benchmark asks this clock to
    predict.  Barrier-only (``mode="nowait"`` rejects a tree: a client
    folded into a partial sum cannot be dropped after the fact).

    No-wait deadlines: an explicit ``deadline_s`` is a static per-microbatch
    window (the pre-adaptive behavior); otherwise an
    :class:`~repro_torch.runtime.deadline.AdaptiveDeadline` — seeded with
    ``default_deadline_s`` and fed every arrival's spread behind its
    microbatch's first cut — tightens/loosens the window online.

    Secure aggregation (``plan.keyx_bytes`` > 0): the one-time key-exchange
    setup round is clocked before any forward — every client uplinks its
    public value, role 0 waits for all K, then relays the K-entry directory
    down each client's downlink; client k's step-0 forwards start when its
    directory lands.  Later steps pay nothing (the window W overlap is
    unaffected); the cost is amortized into ``step_time_s`` over ``steps``.
    """
    if mode not in ("pipelined", "nowait"):
        raise ValueError(f"mode must be pipelined|nowait, got {mode!r}")
    if link.num_clients != plan.num_clients:
        raise ValueError("link model and plan disagree on K")
    if steps < 1 or cross_step < 1:
        raise ValueError(f"steps/cross_step must be >= 1, got "
                         f"{steps}/{cross_step}")
    tree = None
    if plan.tree_fanout:
        compat.check("engine", tree=plan.tree_fanout,
                     nowait=mode == "nowait")
        from repro_torch.runtime.topology import AggTree

        tree = AggTree(plan.num_clients, plan.tree_fanout)
    if mode == "nowait" and deadline_s is None and deadline is None:
        deadline = AdaptiveDeadline(
            plan.num_clients, initial_s=default_deadline_s(plan, link))

    S, W = steps, min(cross_step, steps)
    M, K = plan.microbatches, plan.num_clients
    n_top = len(tree.top_level) if tree is not None else K
    clock = EventClock()
    client_cpu = [Resource(f"client{k}/cpu") for k in range(K)]
    uplink = [Resource(f"client{k}/up") for k in range(K)]
    downlink = [Resource(f"client{k}/down") for k in range(K)]
    server = Resource("server")
    # role-0 NIC: every cut-class frame role 0 receives/sends serializes
    # here (zero-width at the default infinite server_bandwidth_bps)
    server_rx = Resource("server/rx")
    server_tx = Resource("server/tx")

    arrived: dict[tuple[int, int], dict[int, float]] = {}
    first_arrival: dict[tuple[int, int], float] = {}
    started: set[tuple[int, int]] = set()
    report = _report_skeleton(plan, mode, S, cross_step)
    done_t = [0.0]

    server_waiting: dict[int, list[int]] = {}  # step -> mbs gated on collect
    collected = [False] * S
    server_done_count = [0] * S
    finish_submitted = [False] * S
    # per (step, client): jacobians still outstanding before step_done
    bwd_pending = [[M] * K for _ in range(S)]
    step_done_sent: set[tuple[int, int]] = set()
    done_clients = [0] * S

    def finish_at(t: float) -> None:
        done_t[0] = max(done_t[0], t)

    def submit_forwards(k: int, s: int) -> None:
        # the driver ships all M of a step's forwards at submit time, so
        # the client FIFO already holds them before any backward arrives —
        # acquire every slot now (Resource grants in acquire-call order)
        for m in range(M):
            _, end = client_cpu[k].acquire(clock.now, link.client_compute_s(
                k, plan.tower_fwd_flops[k]))
            clock.post(end, lambda m=m: fwd_done(k, s, m))

    def fwd_done(k: int, s: int, m: int) -> None:
        if tree is None:
            send_cut(k, s, m)
        else:
            part_ready(k, s, m)

    def send_cut(k: int, s: int, m: int) -> None:
        _, end = uplink[k].acquire(clock.now, link.transfer_s(k, plan.cut_bytes))
        clock.post(end, lambda: rx_root(k, s, m))

    def rx_root(k: int, s: int, m: int) -> None:
        _, end = server_rx.acquire(
            clock.now, link.server_transfer_s(plan.cut_bytes))
        clock.post(end, lambda: arrive_cut(k, s, m))

    # -- tree fan-in: partial sums climb toward role 0 ------------------------
    if tree is not None:
        need = {k: 1 + len(tree.children(k)) for k in range(K)}
        parts: dict[tuple[int, int, int], int] = {}

        def part_ready(k: int, s: int, m: int) -> None:
            key = (k, s, m)
            parts[key] = parts.get(key, 0) + 1
            if parts[key] < need[k]:
                return
            del parts[key]
            kids = tree.children(k)
            if kids:
                # the relay's partial-sum adds run on its own CPU,
                # contending with its queued forwards/backwards
                _, end = client_cpu[k].acquire(
                    clock.now,
                    link.client_compute_s(k, len(kids) * plan.cut_elements))
                clock.post(end, lambda: send_up(k, s, m))
            else:
                send_up(k, s, m)

        def send_up(k: int, s: int, m: int) -> None:
            _, end = uplink[k].acquire(
                clock.now, link.transfer_s(k, plan.cut_bytes))
            p = tree.parent(k)
            if p is None:
                clock.post(end, lambda: rx_root(k, s, m))
            else:
                clock.post(end, lambda: relay_rx(p, s, m))

        def relay_rx(p: int, s: int, m: int) -> None:
            _, end = downlink[p].acquire(
                clock.now, link.transfer_s(p, plan.cut_bytes))
            clock.post(end, lambda: part_ready(p, s, m))

    def arrive_cut(k: int, s: int, m: int) -> None:
        key = (s, m)
        if key not in first_arrival:
            first_arrival[key] = clock.now
        if deadline is not None:
            # late arrivals observe too, so a recovered straggler can earn
            # its way back under the (loosening) deadline
            deadline.observe(k, clock.now - first_arrival[key])
        if key in started:  # missed the no-wait deadline: discarded at role 0
            return
        arrived.setdefault(key, {})[k] = clock.now
        if len(arrived[key]) == n_top:
            ready_server(s, m)
        elif mode == "nowait" and len(arrived[key]) == 1:
            window = deadline_s if deadline is None else deadline.deadline_s()
            clock.post_in(window, lambda: hit_deadline(s, m))

    def hit_deadline(s: int, m: int) -> None:
        if (s, m) not in started:
            ready_server(s, m)

    ready: set[tuple[int, int]] = set()

    def ready_server(s: int, m: int) -> None:
        if (s, m) in ready:  # deadline fired AND the barrier completed
            return
        ready.add((s, m))
        # the single-threaded driver only reaches step s's microbatches
        # after step s-1's step_done barrier
        if s > 0 and not collected[s - 1]:
            server_waiting.setdefault(s, []).append(m)
            return
        start_server(s, m)

    def start_server(s: int, m: int) -> None:
        started.add((s, m))
        if tree is None:  # tree mode is barrier-only: everyone made it
            for k in range(K):
                if k not in arrived.get((s, m), {}):
                    report.live[s * M + m][k] = 0.0
                    report.misses_per_client[k] += 1
                    note_bwd_skip(s, k)
        # merge + server forward (1/3 of the server flops; bwd is the other 2/3)
        _, end = server.acquire(clock.now, link.server_compute_s(plan.server_flops / 3))
        clock.post(end, lambda: head_exchange(s, m))

    def head_exchange(s: int, m: int) -> None:
        # head output -> role 3 on the label-holder's downlink; the server
        # is FREE to forward the next microbatch meanwhile
        lh = plan.label_holder
        _, end = downlink[lh].acquire(
            clock.now, link.transfer_s(lh, plan.head_bytes))
        clock.post(end, lambda: head_return(s, m))

    def head_return(s: int, m: int) -> None:
        # head jacobian back on the label-holder's uplink (contends with
        # its own cut uplinks)
        lh = plan.label_holder
        _, end = uplink[lh].acquire(
            clock.now, link.transfer_s(lh, plan.head_bytes))
        clock.post(end, lambda: server_bwd(s, m))

    def server_bwd(s: int, m: int) -> None:
        _, end = server.acquire(clock.now, link.server_compute_s(2 * plan.server_flops / 3))
        finish_at(end)
        clock.post(end, lambda: server_done(s, m))

    def server_done(s: int, m: int) -> None:
        if tree is not None:
            # ONE jacobian per top-level client; relays fan it down after
            # their own backward
            for t in tree.top_level:
                clock.post(clock.now, lambda t=t: send_jac(t, s, m))
        else:
            for k in range(K):
                if report.live[s * M + m][k] > 0:
                    clock.post(clock.now, lambda k=k: send_jac(k, s, m))
        server_done_count[s] += 1
        if server_done_count[s] == M:
            # the driver submits finish_step to every client right after
            # the last microbatch's jacobians
            finish_submitted[s] = True
            for k in range(K):
                maybe_step_done(s, k)

    def send_jac(k: int, s: int, m: int) -> None:
        # role-0 NIC first, then the client's own downlink
        _, end = server_tx.acquire(
            clock.now, link.server_transfer_s(plan.cut_bytes))
        clock.post(end, lambda: jac_downlink(k, s, m))

    def jac_downlink(k: int, s: int, m: int) -> None:
        _, end = downlink[k].acquire(clock.now, link.transfer_s(k, plan.cut_bytes))
        clock.post(end, lambda: client_bwd(k, s, m))

    def client_bwd(k: int, s: int, m: int) -> None:
        _, end = client_cpu[k].acquire(clock.now, link.client_compute_s(
            k, plan.tower_bwd_flops[k]))
        finish_at(end)
        clock.post(end, lambda: bwd_complete(s, k))
        if tree is not None and tree.children(k):
            # relay jacobian fan-down: after its own backward, the relay
            # forwards the SAME jacobian to each child over its uplink,
            # into the child's downlink
            def fan(c: int) -> None:
                _, e_up = uplink[k].acquire(
                    clock.now, link.transfer_s(k, plan.cut_bytes))
                clock.post(e_up, lambda: child_rx(c))

            def child_rx(c: int) -> None:
                _, e_dn = downlink[c].acquire(
                    clock.now, link.transfer_s(c, plan.cut_bytes))
                clock.post(e_dn, lambda: client_bwd(c, s, m))

            for c in tree.children(k):
                clock.post(end, lambda c=c: fan(c))

    def bwd_complete(s: int, k: int) -> None:
        bwd_pending[s][k] -= 1
        maybe_step_done(s, k)

    def note_bwd_skip(s: int, k: int) -> None:
        bwd_pending[s][k] -= 1
        maybe_step_done(s, k)

    def maybe_step_done(s: int, k: int) -> None:
        if (not finish_submitted[s] or bwd_pending[s][k] > 0
                or (s, k) in step_done_sent):
            return
        step_done_sent.add((s, k))
        clock.post_in(link.latency_s[k], lambda: step_done_arrive(s))

    def step_done_arrive(s: int) -> None:
        done_clients[s] += 1
        if done_clients[s] == K:
            on_collected(s)

    def on_collected(s: int) -> None:
        collected[s] = True
        # the driver proceeds: merge any queued step-s+1 microbatches ...
        for m in server_waiting.pop(s + 1, []):
            start_server(s + 1, m)
        # ... and submits step s+W, enqueueing its client forwards
        nxt = s + W
        if nxt < S:
            for k in range(K):
                submit_forwards(k, nxt)

    if plan.keyx_bytes:
        # one-time key-agreement setup round gates the step-0 forwards
        pubs_in = [0]

        def keyx_up(k: int) -> None:
            _, end = uplink[k].acquire(
                clock.now, link.transfer_s(k, plan.keyx_bytes))
            clock.post(end, lambda: keyx_gathered())

        def keyx_gathered() -> None:
            pubs_in[0] += 1
            if pubs_in[0] == K:  # role 0 has the full directory: relay it
                for j in range(K):
                    clock.post(clock.now, lambda j=j: keyx_down(j))

        def keyx_down(j: int) -> None:
            _, end = downlink[j].acquire(
                clock.now, link.transfer_s(j, K * plan.keyx_bytes))
            clock.post(end, lambda: keyx_release(j))

        def keyx_release(j: int) -> None:
            # the driver's first W submits were queued behind the key
            # exchange; the client drains them FIFO once its directory lands
            for s in range(W):
                submit_forwards(j, s)

        for k in range(K):
            clock.post(0.0, lambda k=k: keyx_up(k))
    else:
        # pipeline fill: the driver submits steps 0..W-1 back-to-back
        # before collecting step 0
        for s in range(W):
            for k in range(K):
                submit_forwards(k, s)
    clock.run()

    report.total_time_s = done_t[0]
    report.step_time_s = done_t[0] / S
    report.server_busy_s = server.busy_s
    return report


# ---------------------------------------------------------------------------
# numerics: the pipelined/no-wait protocol step (thin wrapper — the
# execution path lives in repro_torch.runtime.executor)
# ---------------------------------------------------------------------------

def pipelined_step(
    tower_fwd: Callable,
    server_fwd: Callable,
    loss_fn: Callable,
    tower_params: list,
    server_params,
    features: list[torch.Tensor],
    labels: torch.Tensor,
    merge: str,
    *,
    microbatches: int = 1,
    mode: str = "pipelined",
    label_holder: int = 0,
    link: Optional[LinkModel] = None,
    plan: Optional[StepPlan] = None,
    deadline_s: Optional[float] = None,
    ema_state: Optional[dict] = None,
    ema_decay: float = 0.95,
    ledger: Optional[Ledger] = None,
    device: DeviceLike = None,
):
    """One pipelined training step; drop-in sibling of ``protocol_step``.

    Returns (loss, tower_grads, server_grads, ledger, report, ema_state).

    At ``mode="pipelined"`` the result equals ``protocol_step`` on the same
    inputs (microbatch gradient averaging == full-batch gradients for the
    mean losses used here); ``mode="nowait"`` additionally needs ``link``
    (who misses a deadline is a property of the network) and an
    ``ema_state`` for imputation (one is created if absent).

    Thin wrapper: the simulated clock (``simulate_pipelined``) decides who
    made each merge; :class:`repro_torch.runtime.executor.Executor` then
    executes the schedule with that liveness over the inline
    :class:`~repro_torch.transport.SimTransport` — the same execution path
    the threaded transport uses.  The default workers and role 0 run on
    ``device`` (``cuda`` unless ``"cpu"`` is asked for), where the params
    and features must already live.
    """
    if mode not in ("pipelined", "nowait"):
        raise ValueError(f"mode must be pipelined|nowait, got {mode!r}")
    dev = resolve_device(device)
    for name, tree in (("tower params", tower_params),
                       ("server params", server_params),
                       ("features", list(features))):
        where = tree_device(tree)
        if where is not None and where.type != dev.type:
            raise ValueError(f"pipelined_step: {name} are on {where}, the "
                             f"step runs on {dev}")
    K = len(tower_params)
    M = microbatches
    B = features[0].shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches={M}")
    mb = B // M

    ledger = ledger if ledger is not None else Ledger()
    if plan is None:
        # timing-only default; callers with a real config should pass
        # plan_step(cfg, ...) so the FLOP model matches costs.py
        with torch.no_grad():
            cut_probe = tower_fwd(tower_params[0], features[0][:1])
        cut_dim = cut_probe.shape[-1]
        fwd = tuple(
            float(mlp_forward_flops([f.shape[-1], cut_dim], mb))
            for f in features
        )
        plan = StepPlan(
            num_clients=K, microbatches=M, tower_fwd_flops=fwd,
            tower_bwd_flops=tuple(2.0 * f for f in fwd),
            # server modeled as one dense layer off the merged width
            server_flops=3.0 * mlp_forward_flops(
                [merged_dim(merge, cut_dim, K), cut_dim], mb),
            cut_bytes=mb * cut_dim * 4, head_bytes=mb * 4,
            merge=merge, cut_elements=mb * cut_dim, label_holder=label_holder,
        )
    if link is None:
        link = LinkModel.uniform(K)
    report = simulate_pipelined(plan, link, mode=mode, deadline_s=deadline_s)

    from repro_torch.runtime.executor import Executor
    from repro_torch.transport.base import SimTransport, TowerWorker

    workers = [TowerWorker(k, tower_fwd, tower_params[k], device=dev)
               for k in range(K)]
    executor = Executor(
        SimTransport(workers), server_fwd, loss_fn, merge,
        mode=mode, microbatches=M, label_holder=label_holder,
        drop_policy="impute" if mode == "nowait" else "fused",
        ema_decay=ema_decay,
    )
    res = executor.run_step(
        server_params, labels, features=list(features),
        liveness=report.live, ema_state=ema_state, ledger=ledger,
        collect_grads=True, report=report,
    )
    return (res.loss, res.tower_grads, res.server_grads, res.ledger,
            res.report, res.ema_state)
