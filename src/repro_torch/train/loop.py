"""Training loop of the port: the monolithic step and split execution.

Two drivers, as in the JAX package's ``repro.train.loop``:

* :func:`train` — the monolithic eager step (centralized, or vertical
  with the towers and their plain merge in one autograd graph; the
  protocol is arithmetic-identical, paper §3), AdamW under the warmup
  cosine schedule, with msgpack checkpoints in the JAX package's format.
* :func:`train_split` — the token-LM families (dense and ssm) split for
  real: per-role workers behind a transport (threads,
  :class:`~repro_torch.transport.InprocTransport`, or one spawned process
  per feature holder,
  :class:`~repro_torch.transport.MultiprocTransport`), the
  :class:`~repro_torch.runtime.executor.Executor` driving
  ``step_schedule`` at role 0, tower params updating locally at the
  clients, the server params at role 0.  Step 0 is verified against the
  serial ``protocol_step``, which merges with the plain version, so every
  run checks the kernel merge (forward and backward) against it.
  ``runtime="nowait"`` runs the no-wait schedule: adaptive wall-clock
  deadlines and EMA imputation of the cuts that miss them, through the
  merge kernels on the card.  The three wire overlays run here too:
  secure aggregation (``cfg.vertical.secure_aggregation``), cut
  compression (``cfg.vertical.compression``) and aggregation trees
  (``agg_tree_fanout``), each verified at step 0 against the serial
  ``protocol_step`` at the JAX package's tolerance.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import compat
from repro_torch.core import compression as comp_lib
from repro_torch.core import secure_agg
from repro_torch.models import backbone
from repro_torch.optim import AdamW
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.tree_util import tree_leaves, tree_map


@dataclass
class TrainMetrics:
    steps: list[int] = field(default_factory=list)
    losses: list[float] = field(default_factory=list)
    step_times: list[float] = field(default_factory=list)
    # largest |step-0 gradient - serial protocol_step gradient|, when verified
    step0_max_dgrad: Optional[float] = None
    # per step, each client's missed microbatches (runtime="nowait")
    misses_per_client: list[list[int]] = field(default_factory=list)
    # per step, the split step's audited wire traffic (train_split)
    ledgers: list = field(default_factory=list)
    # seconds to build the transport's workers (multiproc: spawn each
    # process, build its worker there, connect)
    setup_s: Optional[float] = None
    # secure aggregation: the one-time key exchange's audited traffic, and
    # step 0's max |masked merge - raw sum| at role 0 beside its bound
    keyx_ledger: object = None
    step0_mask_residue: Optional[float] = None
    step0_mask_bound: Optional[float] = None

    def log(self, step: int, loss: float, dt: float) -> None:
        self.steps.append(step)
        self.losses.append(loss)
        self.step_times.append(dt)

    def summary(self) -> dict:
        if not self.losses:
            return {}
        n = max(len(self.losses) // 10, 1)
        return {
            "first_loss": self.losses[0],
            "last_loss": self.losses[-1],
            "best_loss": min(self.losses),
            "mean_step_s": sum(self.step_times[1:])
            / max(len(self.step_times) - 1, 1),
            "loss_drop": self.losses[0] - min(
                sum(self.losses[-n:]) / n, self.losses[-1]),
        }


def train(
    cfg: ArchConfig,
    loader,
    *,
    steps: int = 100,
    learning_rate: float = 3e-4,
    warmup: int = 20,
    grad_clip: float = 1.0,
    log_every: int = 10,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    seed: int = 0,
    param_dtype=torch.float32,
    print_fn: Callable = print,
    device: DeviceLike = None,
    params: Optional[dict] = None,
) -> tuple[dict, TrainMetrics]:
    """The monolithic driver: ``backbone.make_train_step`` under AdamW
    (the warmup cosine schedule, weight decay 0.1, ``grad_clip``), eager,
    on ``device`` (``cuda`` unless ``"cpu"`` is asked for).  Centralized
    (``cfg.vertical`` None) or vertical: the towers and their plain merge
    run inside the one graph, as in the JAX package.

    ``params`` is the initial tree on that device; None runs the port's
    seeded init in ``param_dtype`` (tests hand the JAX package's init in
    here).  With ``checkpoint_path`` the params are saved every
    ``checkpoint_every`` steps (0: never) with the step just taken, and
    at the end with ``steps``."""
    from repro_torch.checkpoint.msgpack_ckpt import save_checkpoint

    dev = resolve_device(device)
    opt = AdamW(
        learning_rate=linear_warmup_cosine(learning_rate, warmup, steps),
        weight_decay=0.1, grad_clip_norm=grad_clip)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = backbone.init_params(cfg, gen, device=dev,
                                      dtype=param_dtype)
    opt_state = opt.init(params)
    step_fn = backbone.make_train_step(cfg, opt)

    metrics = TrainMetrics()
    it = iter(loader)
    for step in range(steps):
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                 for k, v in next(it).items()}  # token ids and labels
        t0 = time.time()
        params, opt_state, loss = step_fn(params, opt_state, batch)
        loss = float(loss)  # waits for the step
        dt = time.time() - t0
        metrics.log(step, loss, dt)
        if step % log_every == 0 or step == steps - 1:
            print_fn(f"step {step:5d}  loss {loss:8.4f}  {dt * 1e3:8.1f} ms")
        if checkpoint_path and checkpoint_every and \
                (step + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint_path, params, step=step)
    if checkpoint_path:
        save_checkpoint(checkpoint_path, params, step=steps)
    return params, metrics


def _make_transport(cfg: ArchConfig, transport: str, *, seed, batch, seq,
                    microbatches, learning_rate, warmup, steps, grad_clip,
                    straggler: Optional[int], straggler_delay_s: float,
                    params: Optional[dict], device: torch.device):
    """One worker per feature holder, each with its own spec: built here
    (inline on role 0's thread, or a thread each), or spawned processes
    that build their own (from ``seed``, or from ``params`` copied across
    when given)."""
    from repro_torch.transport import (InprocTransport, MultiprocTransport,
                                       SimTransport, WorkerSpec,
                                       build_split_worker)

    kwargs = dict(cfg=cfg, seed=seed, batch=batch, seq=seq,
                  microbatches=microbatches, learning_rate=learning_rate,
                  warmup=warmup, steps=steps, grad_clip=grad_clip,
                  params=params, device=device)

    def delay(k: int) -> float:
        return straggler_delay_s if k == straggler else 0.0

    K = cfg.vertical.num_clients
    if transport in ("sim", "inproc"):
        return (SimTransport if transport == "sim" else InprocTransport)([
            build_split_worker(k, forward_delay_s=delay(k), **kwargs)
            for k in range(K)])
    if transport == "multiproc":
        return MultiprocTransport(
            [WorkerSpec(build_split_worker,
                        dict(kwargs, forward_delay_s=delay(k)))
             for k in range(K)], device=device)
    raise ValueError(f"unknown split transport {transport!r}")


class _Step0Tap:
    """Role 0's view of step 0 under secure aggregation: the cut frames
    the executor receives (masked; under a tree, the top-level partial
    sums), kept per microbatch for the in-run cancellation check.  Passes
    everything through."""

    def __init__(self, base):
        self.base = base
        self.num_clients = base.num_clients
        self.frames: dict = {}  # mb -> [frame, ...]

    def submit(self, client: int, request: dict) -> None:
        self.base.submit(client, request)

    def next_response(self, timeout=None):
        got = self.base.next_response(timeout)
        if got is not None and got[1]["op"] == "cut" and \
                got[1]["step"] == 0:
            self.frames.setdefault(got[1]["mb"], []).append(got[1]["cut"])
        return got

    def close(self) -> None:
        self.base.close()


def _mask_residue(frames: dict, program, tower_params, features,
                  microbatches: int, scale: float) -> tuple[float, float]:
    """Largest |sum of role 0's masked frames - sum of the raw cuts| over
    step 0's microbatches, and ``cancellation_bound`` at the raw cuts'
    magnitude: the masks cancelled iff the first is within the second."""
    K = len(tower_params)
    mbsz = features[0].shape[0] // microbatches
    residue, bound = 0.0, 0.0
    with torch.no_grad():
        for m in range(microbatches):
            sl = slice(m * mbsz, (m + 1) * mbsz)
            raw = [program.tower_fwds[k](tower_params[k], features[k][sl])
                   .float() for k in range(K)]
            masked = torch.stack(frames[m]).sum(0)
            residue = max(residue, float(torch.max(torch.abs(
                masked - torch.stack(raw).sum(0)))))
            bound = max(bound, secure_agg.cancellation_bound(
                K, scale, max(max(float(torch.max(torch.abs(r)))
                                  for r in raw), 1.0)))
    return residue, bound


def _verify_step0(res, program, tower_params, server_params, features, ctx,
                  microbatches: int, atol: float, print_fn: Callable,
                  what: str = "") -> float:
    """The acceptance identity: the transport's step-0 gradients must match
    the serial ``protocol_step`` on the same decomposition (the mean of M
    per-microbatch serial steps — what the Executor computes).  Returns
    the largest |difference| over every gradient leaf.

    ``what`` names the overlay: ``"masked-merge "`` (the executor merged
    MASKED cuts, the reference is unmasked: the match proves the masks
    cancelled), ``"compressed-wire "`` (the reference runs the same codec
    from the zero residual every stream starts from) or ``"tree-merge "``
    (relays reassociated the f32 sum, so the match is to a rounding
    tolerance, not bit for bit)."""
    M = microbatches
    mbsz = ctx.shape[0] // M
    losses, tgs, sgs = [], [], []
    for m in range(M):
        sl = slice(m * mbsz, (m + 1) * mbsz)
        loss_m, tg_m, sg_m, _ = program.protocol_step(
            tower_params, server_params, [f[sl] for f in features], ctx[sl])
        losses.append(loss_m)
        tgs.append(tg_m)
        sgs.append(sg_m)
    loss_ref = sum(losses) / M
    tg_ref = tree_map(lambda *x: sum(x) / M, *tgs)
    sg_ref = tree_map(lambda *x: sum(x) / M, *sgs)
    got = tree_leaves((res.tower_grads, res.server_grads))
    want = tree_leaves((tg_ref, sg_ref))
    max_dev = max(float(torch.max(torch.abs(a.float() - b.float())))
                  for a, b in zip(got, want))
    loss_dev = abs(float(res.loss) - float(loss_ref))
    if max_dev > atol or loss_dev > atol:
        raise RuntimeError(
            f"step-0 {what}gradients diverge from the serial protocol_step: "
            f"max |dgrad| {max_dev:.3e}, |dloss| {loss_dev:.3e} > {atol:g}")
    print_fn(f"step-0 {what}verification vs protocol_step: max |dgrad| "
             f"{max_dev:.2e}, |dloss| {loss_dev:.2e} (<= {atol:g}) OK")
    return max_dev


def train_split(
    cfg: ArchConfig,
    loader,
    *,
    steps: int = 100,
    batch: int = 8,
    seq: int = 256,
    transport: str = "inproc",
    runtime: str = "serial",
    microbatches: int = 1,
    inflight_steps: int = 1,
    learning_rate: float = 3e-4,
    warmup: int = 20,
    grad_clip: float = 1.0,
    log_every: int = 10,
    seed: int = 0,
    straggler: Optional[int] = None,
    straggler_delay_s: float = 0.25,
    agg_tree_fanout: Optional[int] = None,
    verify_step0: bool = True,
    verify_atol: float = 1e-5,
    print_fn: Callable = print,
    device: DeviceLike = None,
    params: Optional[dict] = None,
):
    """Train ``cfg``'s split program through the Executor over a real
    transport.  Returns ({"towers": [...], "server": ...}, metrics,
    report).  ``transport`` is ``"inproc"`` (a thread per feature holder),
    ``"multiproc"`` (a spawned process each, computing on ``device`` too)
    or ``"sim"`` (every worker inline on role 0's thread: deterministic,
    the reference a threaded run is held to).

    ``loader`` yields the role-0 batches (an ``LMBatchLoader`` with
    ``seed``); each feature holder regenerates the same token stream from
    ``seed``.  ``runtime`` is ``serial`` (M = 1 barrier), ``pipelined``
    (``microbatches`` per step, staleness 0) or ``nowait`` (adaptive
    deadlines and EMA imputation of late cuts, the EMA state threaded
    from step to step; step 0 is verified only when it had no miss, since
    a miss reroutes its gradients through the imputation by design).
    ``straggler`` slows that client's forwards by ``straggler_delay_s``
    (a wall-clock straggler).  ``inflight_steps`` is the cross-step
    window W of :class:`~repro_torch.runtime.pipeline.StepPipeline` (at
    W > 1 the towers train on delayed gradients).  Runs on ``device``
    (``cuda`` unless ``"cpu"`` is asked for).  ``params`` is the full
    initial param tree on that device; None runs the port's seeded init
    (torch cannot reproduce the JAX package's ``jax.random`` init, so
    tests hand the JAX package's params in here).

    The wire overlays, as in the JAX package:

    * ``cfg.vertical.secure_aggregation``: the one-time key exchange runs
      over the transport (``metrics.keyx_ledger``), the workers mask every
      cut at the source, role 0 merges masked cuts; step 0 is verified
      against the unmasked serial step at ``max(verify_atol, 1e-3)``, and
      role 0's masked step-0 sum against the raw one within
      ``secure_agg.cancellation_bound`` (``metrics.step0_mask_residue`` /
      ``step0_mask_bound``);
    * ``cfg.vertical.compression``: the workers compress their uplinks and
      the executor its downlinks, with error feedback; step 0 is verified
      against the serial step running the same codec at
      ``compression.STEP0_VERIFY_ATOL``;
    * ``agg_tree_fanout=F``: an ``AggTree(K, fanout=F)`` over the
      transport; role 0 merges ``min(F, K)`` relay frames per microbatch;
      step 0 is verified against the flat serial merge at
      ``topology.TREE_VERIFY_ATOL``.

    Unsound compositions (compression with either of the others, secure or
    tree with no-wait or a non-additive merge) reject through the compat
    matrix before any worker is built.
    """
    from repro_torch.models.split_program import get_program
    from repro_torch.runtime.executor import Executor
    from repro_torch.runtime.pipeline import StepPipeline

    if cfg.vertical is None:
        raise ValueError("train_split needs a vertical config")
    if inflight_steps < 1:
        raise ValueError(f"inflight_steps must be >= 1, got {inflight_steps}")
    if runtime not in ("serial", "pipelined", "nowait"):
        raise ValueError(f"runtime must be serial|pipelined|nowait, got "
                         f"{runtime!r}")
    mode = runtime
    M = 1 if runtime == "serial" else microbatches
    W = inflight_steps
    dev = resolve_device(device)

    program = get_program(cfg)
    secure = cfg.vertical.secure_aggregation
    compress = cfg.vertical.compression
    # fail BEFORE any worker is built: unsound compositions through the
    # compat matrix
    compat.check(
        "train", secure=secure, compress=compress, tree=agg_tree_fanout,
        nowait=runtime == "nowait", merge_fn=program.merge_fn,
        merge=program.merge, context=f"train_split({cfg.name})")
    agg_tree = None
    if agg_tree_fanout is not None:
        from repro_torch.runtime.topology import AggTree

        agg_tree = AggTree(num_clients=cfg.vertical.num_clients,
                           fanout=agg_tree_fanout)
    injected = params is not None
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = backbone.init_params(cfg, gen, device=dev)
    # threads partition role 0's tree in place; a spawned process builds
    # its own tower from the seed unless the caller injected a tree (a
    # shipped tree crosses the spawn pipe whole, once per process)
    worker_params = params if injected or transport != "multiproc" else None
    tower_params, server_params = program.partition(params)

    opt = AdamW(
        learning_rate=linear_warmup_cosine(learning_rate, warmup, steps),
        weight_decay=0.1, grad_clip_norm=grad_clip)
    opt_state = opt.init(server_params)

    metrics = TrainMetrics()
    t_setup = time.time()
    tr = _make_transport(
        cfg, transport, seed=seed, batch=batch, seq=seq, microbatches=M,
        learning_rate=learning_rate, warmup=warmup, steps=steps,
        grad_clip=grad_clip, straggler=straggler,
        straggler_delay_s=straggler_delay_s, params=worker_params,
        device=dev)
    metrics.setup_s = time.time() - t_setup
    del params  # role 0 keeps the server tree and the step-0 towers only
    report = None
    max_staleness = 0
    ema_state = None
    b0 = None  # step-0 batch retained for the deferred verification
    it = iter(loader)
    t_last = time.time()

    def handle(res):
        """Consume one collected step: verify (step 0), update the server,
        thread the EMA state, log."""
        nonlocal server_params, opt_state, ema_state, report, t_last, \
            max_staleness
        max_staleness = max(max_staleness, res.report.staleness)
        if res.step == 0 and verify_step0:
            if mode == "nowait" and res.report.total_misses > 0:
                # the serial identity holds only at staleness 0: a step-0
                # deadline miss reroutes gradients through the imputation
                print_fn("step-0 verification skipped: "
                         f"{res.report.total_misses} no-wait deadline "
                         "miss(es) — gradients are intentionally imputed, "
                         "not serial")
            else:
                feats0 = program.features(b0, dev)
                # masked merges carry the f32 mask-cancellation residue;
                # compressed wires verify against a reference running the
                # same codec; relay partial sums reassociate the f32 merge
                if secure:
                    atol, what = max(verify_atol, 1e-3), "masked-merge "
                elif compress is not None:
                    atol = max(verify_atol, comp_lib.STEP0_VERIFY_ATOL)
                    what = "compressed-wire "
                elif agg_tree is not None:
                    from repro_torch.runtime.topology import TREE_VERIFY_ATOL

                    atol, what = max(verify_atol, TREE_VERIFY_ATOL), \
                        "tree-merge "
                else:
                    atol, what = verify_atol, ""
                metrics.step0_max_dgrad = _verify_step0(
                    res, program, tower_params, server_params, feats0,
                    program.batch_ctx(b0, dev), M, atol, print_fn, what)
                if secure:
                    residue, bound = _mask_residue(
                        tap.frames, program, tower_params, feats0, M,
                        executor.secure_scale)
                    tap.frames.clear()
                    if residue > bound:
                        raise RuntimeError(
                            f"step-0 mask cancellation residue "
                            f"{residue:.3e} exceeds its bound {bound:.3e}")
                    metrics.step0_mask_residue = residue
                    metrics.step0_mask_bound = bound
                    print_fn(f"step-0 masked sum at role 0 vs the raw sum: "
                             f"max |residue| {residue:.2e} (<= bound "
                             f"{bound:.2e}) OK")
                if compress is not None:
                    comp_bytes = res.ledger.bytes_with_tag(
                        executor._schedule.cuts[0].tag)
                    with torch.no_grad():
                        cut0 = program.tower_fwds[0](
                            tower_params[0], feats0[0][:batch // M])
                    raw_bytes = M * comp_lib.payload_bytes(cut0, None)
                    print_fn(
                        f"compressed cut uplink ({compress}): {comp_bytes} B"
                        f"/client/step vs {raw_bytes} B raw "
                        f"({comp_bytes / raw_bytes:.2f}x)")
        server_params, opt_state = opt.update(server_params,
                                              res.server_grads, opt_state)
        ema_state = res.ema_state
        report = res.report
        metrics.ledgers.append(res.ledger)
        if mode == "nowait":
            metrics.misses_per_client.append(
                list(res.report.misses_per_client))
        loss = float(res.loss)
        now = time.time()
        dt, t_last = now - t_last, now
        metrics.log(res.step, loss, dt)
        if res.step % log_every == 0 or res.step == steps - 1:
            print_fn(f"step {res.step:5d}  loss {loss:8.4f}  "
                     f"{dt * 1e3:8.1f} ms  [{transport}/{mode}"
                     + (f" W={W}" if W > 1 else "")
                     + (f" misses={res.report.total_misses}"
                        if mode == "nowait" else "") + "]")

    tap = None
    try:
        executor = Executor(tr, program.server_fwd, program.loss_fn,
                            program.merge, mode=mode, microbatches=M,
                            secure_agg=secure, compress=compress,
                            topk_fraction=cfg.vertical.topk_fraction,
                            agg_tree=agg_tree, **program.executor_kwargs)
        # under a tree the Executor wrapped the transport in a TreeRouter:
        # close THAT (it stops its pump before the base)
        tr = executor.transport
        if agg_tree is not None:
            print_fn(f"aggregation tree: fanout {agg_tree.fanout}, depth "
                     f"{agg_tree.depth}, {len(agg_tree.relays)} relay(s) — "
                     f"role 0 merges {len(agg_tree.top_level)} frames/mb "
                     f"instead of {cfg.vertical.num_clients}")
        if secure:
            metrics.keyx_ledger = executor.setup_secure()
            print_fn(f"secure aggregation: pairwise key exchange complete "
                     f"({metrics.keyx_ledger.total()} B over {transport}; "
                     "cut uplinks are masked at the source, role 0 "
                     "observes no raw activation)")
            if verify_step0:
                executor.transport = tap = _Step0Tap(tr)
        pipeline = StepPipeline(executor, window=W)

        def collect_one():
            target = pipeline.next_collect
            handle(pipeline.collect(
                server_params, ema_state=ema_state,
                collect_grads=(target == 0 and verify_step0)))

        for step in range(steps):
            b = next(it)
            if step == 0:
                b0 = b
            pipeline.submit(step, program.batch_ctx(b, dev))
            if pipeline.inflight >= W:
                collect_one()
        while pipeline.inflight:  # drain the fill (steps < W included)
            collect_one()
        final_towers = _collect_tower_params(tr)
    finally:
        tr.close()
    if report is not None:
        # the drain-collected tail always has staleness 0; surface the
        # run's actual delayed-gradient lag on the returned report
        report.staleness = max_staleness
    return ({"towers": final_towers, "server": server_params}, metrics,
            report)


def _collect_tower_params(tr) -> list:
    """Fetch each client's final tower params."""
    K = tr.num_clients
    out: list = [None] * K
    for k in range(K):
        tr.submit(k, {"op": "get_params"})
    seen = 0
    while seen < K:
        got = tr.next_response(60.0)
        if got is None:
            raise RuntimeError("timed out collecting tower params")
        k, resp = got
        if resp["op"] == "params":
            out[k] = resp["params"]
            seen += 1
    return out
