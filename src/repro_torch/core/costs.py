"""Analytic byte models of split serving (the port's own copy).

Cross-checked against the serving driver's ``Ledger`` in
``tests/test_torch_split_serve.py``, and against the JAX package's models
of the same names.
"""
from __future__ import annotations


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
