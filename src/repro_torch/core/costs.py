"""Analytic byte models of split training and serving (the port's own
copy).

Cross-checked against the Executor's and the serving driver's ``Ledger``
in ``tests/test_torch_train.py`` and ``tests/test_torch_split_serve.py``,
and against the JAX package's models of the same names.
"""
from __future__ import annotations


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
