"""Analytic cost models (the port's own copy): the byte models of split
training and serving (plain, masked, tree-routed and compressed wires),
the paper's MLP parameter, FLOP and per-epoch traffic counts (Tables 5
and 6), and the runtime-aware split-depth advisors, which clock their
candidates on :mod:`repro_torch.runtime.engine`.

Cross-checked against the Executor's and the serving driver's ``Ledger``
in ``tests/test_torch_train.py``, ``tests/test_torch_split_serve.py`` and
``tests/test_torch_mlp_exec.py``, and against the JAX package's models of
the same names (the advisors in ``tests/test_torch_runtime_sim.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.vertical_mlp import MLPSplitConfig
from repro_torch.core.merge import merged_dim


@dataclass(frozen=True)
class RoleTraffic:
    sent_bytes: int
    received_bytes: int


def mlp_forward_flops(dims: list[int], batch: int = 1) -> int:
    """2*m*n per dense layer, per sample."""
    total = 0
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        total += 2 * d_in * d_out
    return total * batch


def mlp_param_count(dims: list[int]) -> int:
    total = 0
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        total += d_in * d_out + d_out
    return total


def split_mlp_params(cfg: MLPSplitConfig) -> int:
    total = 0
    for fs in cfg.client_feature_sizes:
        total += mlp_param_count([fs, *cfg.tower_hidden, cfg.cut_dim])
    server_in = merged_dim(cfg.merge, cfg.cut_dim, cfg.num_clients)
    total += mlp_param_count([server_in, *cfg.server_hidden, cfg.num_classes])
    return total


def split_mlp_flops_per_sample(cfg: MLPSplitConfig) -> int:
    total = 0
    for fs in cfg.client_feature_sizes:
        total += mlp_forward_flops([fs, *cfg.tower_hidden, cfg.cut_dim])
    server_in = merged_dim(cfg.merge, cfg.cut_dim, cfg.num_clients)
    total += mlp_forward_flops([server_in, *cfg.server_hidden,
                                cfg.num_classes])
    return total


def cut_bytes(batch_size: int, cut_dim: int, itemsize: int = 4) -> int:
    """Bytes of one plain cut uplink (or its jacobian downlink) per client
    per (micro)batch — the ``cut`` / ``jac`` wire kinds.  For a token LM
    ``batch_size`` counts tokens (batch x sequence)."""
    return batch_size * cut_dim * itemsize


def head_exchange_bytes(batch_size: int, num_classes: int,
                        itemsize: int = 4) -> int:
    """Bytes of one leg of the role-0 <-> role-3 loss exchange per
    (micro)batch: the ``head_out`` downlink and the ``head_jac`` uplink
    are the same (batch x num_classes) payload."""
    return batch_size * num_classes * itemsize


def aux_exchange_bytes(microbatches: int, itemsize: int = 4) -> int:
    """Bytes of the role-0 -> role-3 auxiliary-loss slot per step: one f32
    scalar per microbatch (families whose server computes a loss term of
    its own; the dense family records none)."""
    return microbatches * itemsize


def key_exchange_bytes(num_clients: int, group_bytes: int = 0) -> dict:
    """Bytes of secure aggregation's ONE-TIME pairwise key-agreement round:
    each client uplinks one fixed-size public group element and role 0
    relays the full K-entry directory back down every downlink.
    ``group_bytes=0`` reads the wire size from
    ``secure_agg.KEYX_GROUP_BYTES``."""
    if not group_bytes:
        from repro_torch.core.secure_agg import KEYX_GROUP_BYTES

        group_bytes = KEYX_GROUP_BYTES
    pub = group_bytes
    bcast = num_clients * group_bytes
    return {
        "pub_bytes_per_client": pub,
        "bcast_bytes_per_client": bcast,
        "role0_received": num_clients * pub,
        "role0_sent": num_clients * bcast,
        "total": num_clients * (pub + bcast),
    }


def masked_cut_bytes(batch_size: int, cut_dim: int) -> int:
    """Bytes of one MASKED cut uplink per client per (micro)batch: the
    masks are additive f32 noise, so a masked uplink is exactly the f32
    cut payload (sub-f32 payloads are widened to f32 by the masking)."""
    return batch_size * cut_dim * 4


def tree_cut_bytes(tree, cut_bytes: int, microbatches: int = 1) -> dict:
    """One step's cut traffic under an aggregation tree
    (``runtime.topology.AggTree``, duck-typed): every tree edge carries
    exactly one combined frame per microbatch in each direction, so level
    l carries ``len(edges_at_level(l))`` frames of ``cut_bytes`` each way,
    and role 0 pays only the ``min(F, K)`` level-0 edges."""
    per_level = {
        level: len(tree.edges_at_level(level)) * cut_bytes * microbatches
        for level in range(tree.depth)
    }
    total = sum(per_level.values())
    return {
        "cut_bytes_per_level": per_level,
        "jac_bytes_per_level": dict(per_level),  # symmetric downlink
        "role0_received": per_level[0],
        "role0_sent": per_level[0],
        "total_cut_bytes": total,
        "star_role0_received": tree.num_clients * cut_bytes * microbatches,
    }


def wire_bytes(shape, dtype_bytes: int = 4, scheme=None,
               topk_fraction: float = 0.25) -> int:
    """Bytes of one cut/jacobian payload under a compression scheme — the
    byte model the engine's step plans clock for both cut directions.
    Delegates to ``core.compression.wire_bytes`` so the two cannot drift
    apart."""
    from repro_torch.core.compression import wire_bytes as _codec_wire_bytes

    return _codec_wire_bytes(shape, dtype_bytes, scheme, topk_fraction)


def serve_prefill_bytes(prompt_len: int, cut_dim: int, num_clients: int,
                        *, itemsize: int = 4, token_bytes: int = 4) -> dict:
    """Bytes of ONE request's serving prefill round.

    Role 0 ships the request's int32 prompt ids down to every feature
    holder; each holder replies ONCE with its full prompt-length f32 cut
    slice.  A cut-cache eviction re-runs this round, so total serving
    traffic is ``(requests + re-prefills)`` times this model plus
    :func:`serve_decode_bytes` per generated-token round."""
    prompt = prompt_len * token_bytes
    cut = prompt_len * cut_dim * itemsize
    return {
        "prompt_bytes_per_client": prompt,
        "cut_bytes_per_client": cut,
        "role0_sent": num_clients * prompt,
        "role0_received": num_clients * cut,
        "total": num_clients * (prompt + cut),
    }


def serve_decode_bytes(cut_dim: int, num_clients: int, *, rounds: int = 1,
                       itemsize: int = 4, token_bytes: int = 4) -> dict:
    """Bytes of a request's serving DECODE rounds: one int32 token id down
    and one (1, 1, cut_dim) f32 cut frame up per client per round.  A
    request generating N tokens runs N - 1 rounds (the first token samples
    from the prefill logits)."""
    token = token_bytes * rounds
    cut = cut_dim * itemsize * rounds
    return {
        "token_bytes_per_client": token,
        "cut_bytes_per_client": cut,
        "role0_sent": num_clients * token,
        "role0_received": num_clients * cut,
        "total": num_clients * (token + cut),
    }


def _clock_placements(plans: dict, link, objective: str,
                      cross_step: int) -> tuple[dict, int]:
    """Shared sweep core of the two placement advisors: clock every
    candidate ``depth -> StepPlan`` under the chosen objective (the
    cross-step window amortized over a short multi-step run) and return
    (times_by_depth, argmin_depth — shallower wins ties)."""
    from repro_torch.runtime.engine import simulate_pipelined, simulate_serial

    sim_steps = 1 if cross_step == 1 else 2 * cross_step
    times: dict[int, float] = {}
    for depth, plan in plans.items():
        if objective == "serial":
            times[depth] = simulate_serial(plan, link).step_time_s
        else:
            times[depth] = simulate_pipelined(
                plan, link, steps=sim_steps,
                cross_step=cross_step).step_time_s
    recommended = min(times, key=lambda d: (times[d], d))
    return times, recommended


def advise_split_depth(
    cfg: MLPSplitConfig,
    *,
    bandwidth_bytes_per_s: float,
    client_flops_per_s: float,
    server_flops_per_s: float,
    batch_size: int = 32,
    min_private_layers: int = 1,
    objective: str = "heuristic",
    microbatches: int = 4,
    latency_s: float = 0.0,
    cross_step: int = 1,
    tree_fanout=None,
) -> dict:
    """The paper's §4.4 placement guidance, made executable and
    runtime-aware.

    ``objective="heuristic"`` is the paper's rule: communication-bound
    federations move layers into the clients so the cut stays small,
    compute-bound ones keep the towers at the privacy minimum.
    ``"serial"`` / ``"pipelined"`` sweep every placement of the hidden
    stack between towers and server and clock each candidate with
    ``runtime.engine.simulate_serial`` / ``simulate_pipelined`` (M =
    ``microbatches``, driver window ``cross_step``, an optional fanout-F
    aggregation tree) under a uniform ``LinkModel`` built from the given
    rates, and recommend the argmin.  Returns the recommended tower depth
    (in units of the configured hidden stack) with the per-candidate step
    times (simulated objectives) or the per-batch estimates (heuristic).
    """
    if objective not in ("heuristic", "serial", "pipelined"):
        raise ValueError(
            f"objective must be heuristic|serial|pipelined, got {objective!r}")

    if objective == "heuristic":
        cut_bytes = batch_size * cfg.cut_dim * 4
        comm_s = 2 * cut_bytes * cfg.num_clients / bandwidth_bytes_per_s

        tower_flops = sum(
            mlp_forward_flops([fs, *cfg.tower_hidden, cfg.cut_dim], batch_size)
            for fs in cfg.client_feature_sizes
        )
        server_in = merged_dim(cfg.merge, cfg.cut_dim, cfg.num_clients)
        server_flops = mlp_forward_flops(
            [server_in, *cfg.server_hidden, cfg.num_classes], batch_size
        )
        t_client = tower_flops / client_flops_per_s
        t_server = server_flops / server_flops_per_s

        comm_bound = comm_s > (t_client + t_server)
        recommended = (
            len(cfg.tower_hidden) + len(cfg.server_hidden)  # deep towers
            if comm_bound
            else min_private_layers  # thin towers, core on role 0
        )
        return {
            "objective": objective,
            "comm_bound": bool(comm_bound),
            "comm_s_per_batch": comm_s,
            "client_s_per_batch": t_client,
            "server_s_per_batch": t_server,
            "recommended_tower_layers": recommended,
            "rationale": (
                "communication-bound: move layers into the clients so the "
                "cut stays small" if comm_bound else
                "compute-bound: keep towers at the privacy-minimum and put "
                "the core on the role-0 worker"
            ),
        }

    import dataclasses

    from repro_torch.runtime.engine import plan_step
    from repro_torch.runtime.links import LinkModel

    if batch_size % microbatches:
        raise ValueError(
            f"batch {batch_size} not divisible by microbatches={microbatches}")
    stack = (*cfg.tower_hidden, *cfg.server_hidden)
    link = LinkModel.uniform(
        cfg.num_clients, latency_s=latency_s,
        bandwidth_bps=bandwidth_bytes_per_s,
        client_flops_per_s=client_flops_per_s,
        server_flops_per_s=server_flops_per_s,
    )
    plans = {
        depth: plan_step(
            dataclasses.replace(cfg, tower_hidden=stack[:depth],
                                server_hidden=stack[depth:]),
            batch_size, microbatches, tree_fanout=tree_fanout)
        for depth in range(min_private_layers, len(stack) + 1)
    }
    times, recommended = _clock_placements(plans, link, objective, cross_step)
    return {
        "objective": objective,
        "recommended_tower_layers": recommended,
        "step_time_s_by_depth": times,
        "cross_step": cross_step,
        "rationale": (
            f"{objective} clock argmin over placements of the "
            f"{len(stack)}-layer hidden stack (M={microbatches}"
            + (f", W={cross_step}" if cross_step > 1 else "") + ")"
        ),
    }


def advise_arch_split_depth(
    cfg,
    *,
    batch_size: int,
    seq_len: int,
    bandwidth_bytes_per_s: float = 1e8,
    client_flops_per_s: float = 5e9,
    server_flops_per_s: float = 5e10,
    objective: str = "pipelined",
    microbatches: int = 4,
    cross_step: int = 1,
    latency_s: float = 1e-3,
    min_tower_layers: int = 1,
    tree_fanout=None,
) -> dict:
    """Runtime-aware tower-depth placement for an LM
    :class:`~repro_torch.configs.base.ArchConfig`: every ``tower_layers``
    placement in ``[min_tower_layers, num_layers - 1]`` is planned with
    ``runtime.engine.plan_from_arch`` and clocked with ``simulate_serial``
    / ``simulate_pipelined`` under a uniform ``LinkModel`` built from the
    given rates; the argmin is recommended."""
    import dataclasses

    from repro_torch.runtime.engine import plan_from_arch
    from repro_torch.runtime.links import LinkModel

    if objective not in ("serial", "pipelined"):
        raise ValueError(
            f"objective must be serial|pipelined, got {objective!r}")
    v = cfg.vertical
    if v is None:
        raise ValueError(f"{cfg.name} has no vertical config")
    if batch_size % microbatches:
        raise ValueError(
            f"batch {batch_size} not divisible by microbatches={microbatches}")
    if not (1 <= min_tower_layers < cfg.num_layers):
        raise ValueError(
            f"min_tower_layers must be in [1, {cfg.num_layers - 1}]")

    link = LinkModel.uniform(
        v.num_clients, latency_s=latency_s,
        bandwidth_bps=bandwidth_bytes_per_s,
        client_flops_per_s=client_flops_per_s,
        server_flops_per_s=server_flops_per_s,
    )
    plans = {
        depth: plan_from_arch(
            cfg.with_vertical(dataclasses.replace(v, tower_layers=depth)),
            batch_size, seq_len, microbatches, tree_fanout=tree_fanout)
        for depth in range(min_tower_layers, cfg.num_layers)
    }
    times, recommended = _clock_placements(plans, link, objective, cross_step)
    return {
        "objective": objective,
        "recommended_tower_layers": recommended,
        "configured_tower_layers": v.tower_layers,
        "step_time_s_by_depth": times,
        "cross_step": cross_step,
        "rationale": (
            f"{objective} clock argmin over tower_layers placements of "
            f"{cfg.name}'s {cfg.num_layers}-layer stack (K={v.num_clients}, "
            f"M={microbatches}"
            + (f", W={cross_step}" if cross_step > 1 else "") + ")"
        ),
    }


def epoch_traffic(cfg: MLPSplitConfig, num_samples: int, batch_size: int,
                  bytes_per_float: int = 4,
                  aux_loss: bool = False) -> dict[str, RoleTraffic]:
    """Per-epoch traffic by role, following the paper's §4.4 accounting.

    Role 1 = features only, role 3 = features + labels (computes the
    loss), role 0 = compute-only server.  Per batch, every feature holder
    sends its cut activation (B x cut_dim) to role 0 and receives the
    matching jacobian back; role 0 sends the head output (B x num_classes)
    to role 3 for the loss and receives the head jacobian back; with
    ``aux_loss``, role 0 also ships one f32 auxiliary-loss scalar per
    batch to role 3."""
    num_batches = num_samples // batch_size
    cut = cut_bytes(batch_size, cfg.cut_dim, bytes_per_float)
    head = head_exchange_bytes(batch_size, cfg.num_classes, bytes_per_float)
    aux = aux_exchange_bytes(1) if aux_loss else 0

    role1 = RoleTraffic(sent_bytes=cut * num_batches,
                        received_bytes=cut * num_batches)
    # role 3 = one feature-holder + the loss exchange
    role3 = RoleTraffic(sent_bytes=(cut + head) * num_batches,
                        received_bytes=(cut + head + aux) * num_batches)
    # role 0 receives K cut tensors + 1 head jacobian; sends K jacobians +
    # the head output (+ the aux scalar when the family carries one)
    k = cfg.num_clients
    role0 = RoleTraffic(sent_bytes=(cut * k + head + aux) * num_batches,
                        received_bytes=(cut * k + head) * num_batches)
    return {"role1": role1, "role3": role3, "role0": role0}
