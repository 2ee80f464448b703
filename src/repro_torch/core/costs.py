"""Analytic cost models (the port's own copy): the byte models of split
training and serving, and the paper's MLP parameter, FLOP and per-epoch
traffic counts (Tables 5 and 6).

Cross-checked against the Executor's and the serving driver's ``Ledger``
in ``tests/test_torch_train.py``, ``tests/test_torch_split_serve.py`` and
``tests/test_torch_mlp_exec.py``, and against the JAX package's models of
the same names.
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
