"""End-to-end training launcher of the port, on the card by default.

Examples:
  # monolithic training of vertical smollm-360m (K = 4 towers, avg) with a
  # checkpoint in the JAX package's msgpack format:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 300 --batch 8 --seq 256 --checkpoint ckpt/smollm.msgpack

  # centralized baseline (paper Table 2 comparison):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --vertical off --steps 300

  # SPLIT EXECUTION over real per-role processes: spawn one OS process per
  # feature holder (each builds only its own tower and token stream from
  # the seed, on its own CUDA context), train through the Executor over
  # TCP loopback sockets, and verify step-0 gradients against the serial
  # protocol_step:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 5 --transport multiproc

  # the same over threads, pipelined with adaptive no-wait deadlines and a
  # wall-clock straggler on client 1:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 20 --transport inproc --runtime nowait --microbatches 4 \\
      --straggler 1

  # the wire overlays over processes: top-k cut compression, and secure
  # aggregation along a fanout-2 aggregation tree:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 5 --transport multiproc --compress topk --topk-fraction 0.25
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --steps 5 --transport multiproc --secure-agg --agg-tree-fanout 2

  # any of these on the CPU (the plain PyTorch path, no kernel), reduced:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --reduced --steps 3 --batch 4 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --reduced --steps 3 --batch 4 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch deepseek-moe-16b --reduced --transport inproc --steps 3 \\
      --batch 4 --seq 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
      --reduced --transport inproc --steps 3 --batch 4 --seq 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-26b \\
      --reduced --transport inproc --steps 3 --batch 4 --seq 40 --device cpu

The flags, their checks and their messages are the JAX package's
``repro.launch.train``'s, plus ``--device {cuda,cpu}``.  A rejected
composition of flags reads as there (the compat matrix, through
:func:`repro_torch.core.compat.cli_reject`).  A moe config's split run
prints its router aux loss and the bytes of the protocol's aux slot.
Every config of the JAX package runs, whisper-tiny (audio) and
internvl2-26b (vlm) included; a vlm ``--seq`` counts the vision tokens,
and must exceed them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch import resolve_device
from repro_torch.configs.base import VerticalConfig, get_arch
from repro_torch.core import compat
from repro_torch.data.loader import LMBatchLoader

def scale_config(cfg, scale: str):
    """Budget presets: shrink depth/width, keep the family + technique."""
    if scale == "full":
        return cfg
    presets = {
        # ~100M params with the smollm tokenizer (embed ~38M + 12 layers)
        "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                     d_ff=2048),
        "25m": dict(num_layers=6, d_model=384, num_heads=6, num_kv_heads=2,
                    d_ff=1024),
        "10m": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                    d_ff=512),
    }
    if scale not in presets:
        raise SystemExit(f"unknown --scale {scale}")
    fields = dict(presets[scale])
    if cfg.family == "ssm":
        # pure Mamba: no attention heads, and the FFN lives inside the SSD
        # block, so the preset d_ff is meaningless too
        for f in ("num_heads", "num_kv_heads", "d_ff"):
            fields.pop(f)
    elif cfg.family == "hybrid":
        # zamba2-style: the shared attention block derives its head layout
        # from the arch config, but its FFN width IS the preset d_ff
        for f in ("num_heads", "num_kv_heads"):
            fields.pop(f)
    return dataclasses.replace(cfg, **fields)


def _runtime_report(cfg, args) -> dict:
    """Clock one training step of the chosen --runtime schedule on the
    default federation link model (``repro_torch.runtime``); pure
    simulation on the host, the training run above is unaffected."""
    from repro_torch.runtime import (LinkModel, plan_from_arch,
                                     simulate_pipelined, simulate_serial)

    M = args.microbatches if args.runtime != "serial" else 1
    W = args.inflight_steps
    plan = plan_from_arch(cfg, args.batch, args.seq, M)
    link = LinkModel.uniform(cfg.vertical.num_clients)
    if args.straggler is not None:
        link = link.with_straggler(args.straggler, slowdown=10.0)
    serial_s = simulate_serial(plan, link).step_time_s
    if args.runtime == "serial" and W == 1:
        report = {"mode": "serial", "step_time_s": serial_s}
    else:
        sim_mode = "pipelined" if args.runtime == "serial" else args.runtime
        sim = simulate_pipelined(plan, link, mode=sim_mode,
                                 steps=1 if W == 1 else 2 * W, cross_step=W)
        report = {
            "mode": sim.mode,
            "step_time_s": sim.step_time_s,
            "speedup_vs_serial": serial_s / sim.step_time_s,
            "microbatches": sim.microbatches,
            "inflight_steps": W,
            # per-step figures, so W settings compare with each other and
            # with the measured per-step ExecReport
            "sim_steps": sim.steps,
            "deadline_misses_per_step": sim.total_misses / sim.steps,
            "cut_bytes_per_client": sim.cut_bytes_per_client // sim.steps,
        }
    # runtime-aware placement: where the sweep would put the cut for this
    # schedule (costs.advise_arch_split_depth over plan_from_arch)
    if cfg.num_layers > 1:
        from repro_torch.core.costs import advise_arch_split_depth

        # a cross-step window makes even --runtime serial an overlapped
        # (pipelined) schedule, as the clock above does
        advise = advise_arch_split_depth(
            cfg, batch_size=args.batch, seq_len=args.seq,
            objective="serial" if (args.runtime == "serial" and W == 1)
            else "pipelined",
            microbatches=M, cross_step=W)
        report["advised_tower_layers"] = advise["recommended_tower_layers"]
        report["configured_tower_layers"] = cfg.vertical.tower_layers
    print(f"runtime[{args.runtime}] simulated step "
          f"{report['step_time_s']*1e3:.2f} ms"
          + (f" ({report['speedup_vs_serial']:.2f}x vs serial)"
             if "speedup_vs_serial" in report else "")
          + (f"  advised tower_layers={report['advised_tower_layers']}"
             if "advised_tower_layers" in report else ""))
    return report


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--scale", default="full",
                    choices=["full", "100m", "25m", "10m"])
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduced variant")
    ap.add_argument("--vertical", default="on", choices=["on", "off"])
    ap.add_argument("--merge", default=None,
                    help="override the cut-layer merge strategy")
    ap.add_argument("--clients", type=int, default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--json", default=None, help="write metrics json here")
    ap.add_argument("--runtime", default="serial",
                    choices=["serial", "pipelined", "nowait"],
                    help="split-training schedule to clock "
                         "(repro_torch.runtime)")
    ap.add_argument("--microbatches", type=int, default=4,
                    help="pipeline depth for --runtime pipelined/nowait")
    ap.add_argument("--inflight-steps", type=int, default=1,
                    help="cross-step window W: submit step t+1 tower "
                         "forwards while step t's server backward/jacobian "
                         "drain is in flight (W>1 trains towers on delayed "
                         "gradients, one update behind; W=1 is the exact "
                         "per-step barrier)")
    ap.add_argument("--straggler", type=int, default=None,
                    help="degrade this client 10x in the runtime simulation "
                         "(real wall-clock delay under --transport "
                         "inproc/multiproc)")
    ap.add_argument("--transport", default="sim",
                    choices=["sim", "inproc", "multiproc"],
                    help="sim: monolithic step + simulated federation "
                         "clock; inproc/multiproc: SPLIT EXECUTION through "
                         "the Executor over per-role threads/processes "
                         "(repro_torch.transport)")
    ap.add_argument("--secure-agg", action="store_true",
                    help="Bonawitz-style secure aggregation: in-protocol "
                         "pairwise key exchange, cut uplinks masked at the "
                         "source, role 0 merges masked cuts and never "
                         "observes a raw activation (sum/avg merges, "
                         "barrier runtimes, split execution only)")
    ap.add_argument("--compress", default=None, choices=["topk", "int8"],
                    help="compress cut traffic on the wire "
                         "(repro_torch.core.compression): workers compress "
                         "cut uplinks at the source with error feedback, "
                         "the executor compresses jacobian downlinks "
                         "symmetrically; step 0 verifies against the serial "
                         "protocol_step running the same codec.  Mutually "
                         "exclusive with --secure-agg")
    ap.add_argument("--topk-fraction", type=float, default=0.25,
                    help="fraction of cut entries kept per vector under "
                         "--compress topk")
    ap.add_argument("--agg-tree-fanout", type=int, default=None,
                    help="overlay a fanout-F aggregation tree on split "
                         "execution (repro_torch.runtime.topology): relay "
                         "workers partial-sum their subtree's cut uplinks "
                         "so role 0 merges/fans-out min(F, K) frames per "
                         "microbatch instead of K.  Additive merges "
                         "(sum/avg) only; composes with --secure-agg, "
                         "mutually exclusive with --compress and --runtime "
                         "nowait")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where role 0 and every feature holder compute "
                         "(cuda: the kernels; cpu: their plain versions)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = scale_config(cfg, args.scale)
    if args.vertical == "off":
        cfg = cfg.with_vertical(None)
    elif args.merge or args.clients:
        v = cfg.vertical or VerticalConfig()
        v = dataclasses.replace(
            v,
            merge=args.merge or v.merge,
            num_clients=args.clients or v.num_clients,
        )
        cfg = cfg.with_vertical(v)

    if cfg.vertical is None and (args.runtime != "serial"
                                 or args.straggler is not None
                                 or args.transport != "sim"
                                 or args.secure_agg
                                 or args.compress):
        raise SystemExit(
            f"--runtime {args.runtime}/--straggler/--transport/--secure-agg/"
            "--compress need a vertical config; this run is centralized "
            "(--vertical off or arch without one)"
        )
    # every unsound flag composition rejects through the ONE compat matrix,
    # phrased flag-first by compat.cli_reject
    try:
        compat.check(
            "launch", secure=args.secure_agg, compress=args.compress or None,
            tree=args.agg_tree_fanout, nowait=args.runtime == "nowait",
            merge=cfg.vertical.merge if cfg.vertical is not None else None)
    except compat.CompatError as e:
        raise compat.cli_reject(e) from None
    if args.compress:
        if not (0.0 < args.topk_fraction <= 1.0):
            raise SystemExit(
                f"--topk-fraction must be in (0, 1], got {args.topk_fraction}")
        cfg = cfg.with_vertical(dataclasses.replace(
            cfg.vertical, compression=args.compress,
            topk_fraction=args.topk_fraction))
    if args.secure_agg:
        if args.transport == "sim":
            raise SystemExit(
                "--secure-agg needs split execution (--transport "
                "inproc/multiproc): the sim path runs the monolithic "
                "jitted step, there is no uplink to mask")
        try:
            cfg = cfg.with_vertical(dataclasses.replace(
                cfg.vertical, secure_aggregation=True))
        except ValueError as e:  # non-additive merge rejected by the config
            raise SystemExit(f"--secure-agg: {e}")
    if args.agg_tree_fanout is not None:
        if args.transport == "sim":
            raise SystemExit(
                "--agg-tree-fanout needs split execution (--transport "
                "inproc/multiproc): the sim path runs the monolithic jitted "
                "step, there are no relay workers to aggregate at")
        if args.agg_tree_fanout < 2:
            raise SystemExit(
                f"--agg-tree-fanout must be >= 2, got {args.agg_tree_fanout} "
                "(fanout 1 is a chain — every hop still serializes and role "
                "0 gains nothing)")
    if args.transport != "sim":
        # every ported family has a registered SplitProgram — this only
        # rejects a config with no vertical section (checked above)
        from repro_torch.models.split_program import get_program

        get_program(cfg)
        if args.checkpoint:
            raise SystemExit("--checkpoint is not supported with split "
                             "execution (tower params live at the clients)")
    if cfg.vertical is not None:
        # fail fast — the runtime report renders after training finishes
        if args.microbatches < 1:
            raise SystemExit(
                f"--microbatches must be >= 1, got {args.microbatches}")
        if args.inflight_steps < 1:
            raise SystemExit(
                f"--inflight-steps must be >= 1, got {args.inflight_steps}")
        if args.runtime != "serial" and args.batch % args.microbatches:
            raise SystemExit(
                f"--batch {args.batch} not divisible by "
                f"--microbatches {args.microbatches}"
            )
        if args.straggler is not None and not (
                0 <= args.straggler < cfg.vertical.num_clients):
            raise SystemExit(
                f"--straggler {args.straggler} out of range for "
                f"{cfg.vertical.num_clients} clients"
            )
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from None

    from repro_torch.models.backbone import param_count

    n_params = param_count(cfg)
    print(f"arch={cfg.name} family={cfg.family} params={n_params/1e6:.1f}M "
          f"vertical={cfg.vertical} device={device}")
    loader = LMBatchLoader(cfg, args.batch, args.seq, seed=args.seed)
    if args.transport != "sim":
        from repro_torch.train.loop import train_split

        _, metrics, report = train_split(
            cfg, loader, steps=args.steps, batch=args.batch, seq=args.seq,
            transport=args.transport, runtime=args.runtime,
            microbatches=args.microbatches,
            inflight_steps=args.inflight_steps, learning_rate=args.lr,
            seed=args.seed, straggler=args.straggler,
            agg_tree_fanout=args.agg_tree_fanout, device=device,
        )
        summary = metrics.summary()
        summary.update(arch=cfg.name, params=n_params, steps=args.steps,
                       vertical=args.vertical, transport=args.transport,
                       inflight_steps=args.inflight_steps,
                       secure_agg=args.secure_agg, compress=args.compress,
                       agg_tree_fanout=args.agg_tree_fanout)
        if report is not None:
            summary["runtime"] = {
                "mode": report.mode,
                "transport": args.transport,
                "step_time_s": report.step_time_s,
                "staleness": report.staleness,
                "deadline_misses": report.total_misses,
                "cut_bytes_per_client": report.cut_bytes_per_client,
            }
    else:
        from repro_torch.train.loop import train

        _, metrics = train(
            cfg, loader, steps=args.steps, learning_rate=args.lr,
            checkpoint_path=args.checkpoint, seed=args.seed, device=device,
        )
        summary = metrics.summary()
        summary.update(arch=cfg.name, params=n_params, steps=args.steps,
                       vertical=args.vertical)
        if cfg.vertical is not None:
            summary["runtime"] = _runtime_report(cfg, args)
    print(json.dumps(summary, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"summary": summary, "losses": metrics.losses}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
