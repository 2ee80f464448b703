"""Bonawitz-style secure aggregation for the sum/avg merges.

Protocol shape (Bonawitz et al. 2016, simplified to the
honest-but-curious, no-dropout-recovery case the paper cites):

* every ordered client pair (i < j) agrees on a seed ``s_ij``;
* client i adds ``+PRG(s_ij)`` for every j > i and ``-PRG(s_ji)`` for every
  j < i to its cut activation before sending;
* the pairwise masks cancel in the sum, so the server learns only the
  aggregate — never an individual client's cut activation.

Two ways the per-pair seeds come to exist:

* **centralized** (simulation and tests): :func:`pair_seed` derives every
  pair's seed from a shared ``base_seed`` — any party could regenerate the
  masks.  Convenient for asserting the arithmetic, useless for privacy.
* **in-protocol** (the transports): each client draws an ephemeral
  Diffie-Hellman keypair (:func:`dh_keypair`), role 0 relays the fixed-size
  public group elements (``KEYX_GROUP_BYTES`` each), and each pair derives
  its shared seed locally (:func:`dh_shared` -> :func:`seed_from_shared`).
  Role 0 forwards public values only; it never holds any pair's seed.

Threat model: role 0 is honest-but-curious (it runs the protocol and
inspects everything it receives: the public key-exchange values and the
per-client *masked* cuts, from which only the K-client sum is
recoverable); clients do not collude; there is no dropout recovery — a
client whose masked cut misses a merge leaves its masks uncancelled, so
secure aggregation requires barrier execution (the compat matrix rejects
no-wait and EMA imputation).

The PRG.  The DH group (the Mersenne prime 2^521 - 1, generator 3) and
the key agreement are the JAX package's, integer for integer.  The masks
are not: the JAX package draws them with ``jax.random`` (threefry), which
torch cannot reproduce, so this port draws each pair's noise from its own
``torch.Generator`` on the payload's device, seeded from sha256 of the
pair's seed and the round, cut to 63 bits.  The two packages therefore
mask differently and agree only on the unmasked aggregate.  CPU and CUDA
generators give different normals from one seed, so the two ends of a
pair must draw on the same device type, or the masks do not cancel: the
``Executor``'s key exchange refuses a mixed federation.

Masks live in float32; cancellation is NOT exact.  Each mask value is
added and subtracted once as the identical f32 number, but the two
occurrences interleave with different payloads in the sum, so the
aggregate carries an ulp-level residue that grows with the mask
``scale``, the client count and the payload magnitude.
:func:`cancellation_bound` states the bound and :func:`secure_sum`
asserts it.

Mask freshness: ``round_idx`` is required everywhere.  Reusing a round
reuses the identical masks, and a server differencing two uplinks masked
for the same round recovers the raw payload delta exactly — the executor
path derives a fresh ``round_idx = step * microbatches + mb`` per
``(step, microbatch)``.
"""
from __future__ import annotations

import hashlib
import math
import secrets
from typing import Optional

import torch

# placeholder DH group of the JAX package: the multiplicative group mod
# the Mersenne prime M521.  Public values are fixed-size group elements.
DH_PRIME = (1 << 521) - 1
DH_GENERATOR = 3
KEYX_GROUP_BYTES = 66  # ceil(521 / 8): wire size of one public value
_DH_SECRET_BITS = 512
_SEED_BITS = 63  # a torch.Generator seed must fit a signed 64-bit int


def dh_keypair() -> tuple[int, int]:
    """Ephemeral (secret, public) pair for the in-protocol key exchange."""
    secret = secrets.randbits(_DH_SECRET_BITS) | 1
    return secret, pow(DH_GENERATOR, secret, DH_PRIME)


def dh_shared(secret: int, peer_pub: int) -> int:
    """The pair's shared group element: ``peer_pub ** secret`` — symmetric,
    and never computable by role 0 (which only relays public values)."""
    peer_pub = int(peer_pub)
    if not 1 < peer_pub < DH_PRIME:
        raise ValueError(f"peer public value outside the group: {peer_pub}")
    return pow(peer_pub, secret, DH_PRIME)


def _digest63(*parts: bytes) -> int:
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest()[:8], "big") & ((1 << _SEED_BITS) - 1)


def seed_from_shared(shared: int) -> int:
    """The pair's mask seed from a DH shared secret (both pair ends derive
    the identical seed, so the +/- masks cancel)."""
    return _digest63(int(shared).to_bytes(KEYX_GROUP_BYTES, "big"))


def _round_seed(pair_key: int, round_idx: int) -> int:
    """The seed of one pair's noise in one round."""
    return _digest63(int(pair_key).to_bytes(8, "big"),
                     int(round_idx).to_bytes(8, "big", signed=True))


def pair_seed(base_seed: int, i: int, j: int, round_idx: int) -> int:
    """Deterministic per-pair, per-round seed (i < j canonical order) —
    the CENTRALIZED path; transports derive pair seeds via ``dh_*``.
    ``round_idx`` is required: reusing a round reuses the masks."""
    lo, hi = (i, j) if i < j else (j, i)
    return _digest63(*(int(v).to_bytes(8, "big", signed=True)
                       for v in (base_seed, lo, hi, round_idx)))


def mask_from_keys(pair_keys: dict, client: int, shape, round_idx: int,
                   scale: float = 1.0, *,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """The net f32 mask for ``client`` given its per-pair seeds ``{other:
    seed}``: fresh noise per ``round_idx``, one ``torch.Generator`` per
    draw on ``device``, sign by the canonical pair order."""
    device = torch.device("cpu") if device is None else torch.device(device)
    mask = torch.zeros(shape, dtype=torch.float32, device=device)
    for other in sorted(pair_keys):
        gen = torch.Generator(device=device).manual_seed(
            _round_seed(pair_keys[other], round_idx))
        noise = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * scale
        mask = mask + noise if client < other else mask - noise
    return mask


def client_mask(base_seed: int, client: int, num_clients: int, shape,
                round_idx: int, scale: float = 1.0, *,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """The net mask client ``client`` adds to its payload (centralized)."""
    keys = {other: pair_seed(base_seed, client, other, round_idx)
            for other in range(num_clients) if other != client}
    # round_idx is already inside pair_seed; mask_from_keys adds round 0
    return mask_from_keys(keys, client, shape, 0, scale, device=device)


def mask_payload(payload: torch.Tensor, base_seed: int, client: int,
                 num_clients: int, round_idx: int,
                 scale: float = 1.0) -> torch.Tensor:
    """What client ``client`` actually transmits (centralized seeds)."""
    m = client_mask(base_seed, client, num_clients, payload.shape,
                    round_idx, scale, device=payload.device)
    return payload.float() + m


def mask_payload_with_keys(payload: torch.Tensor, pair_keys: dict,
                           client: int, round_idx: int,
                           scale: float = 1.0) -> torch.Tensor:
    """What a transport worker actually transmits (DH-derived pair seeds);
    a bf16 payload ships as f32."""
    m = mask_from_keys(pair_keys, client, payload.shape, round_idx, scale,
                       device=payload.device)
    return payload.float() + m


def cancellation_bound(num_clients: int, scale: float = 1.0,
                       payload_abs: float = 1.0) -> float:
    """Upper bound on ``max|secure_sum - raw_sum|`` per element.

    2*K*(K-1) mask terms of magnitude ~4*scale (4-sigma of the normal PRG)
    enter the f32 sum interleaved with K payload terms; each partial sum is
    O(scale*sqrt(K) + payload_abs) and every add rounds at eps.  The factor
    8 is slack over the expected sqrt-accumulation."""
    terms = 2 * num_clients * max(num_clients - 1, 1)
    magnitude = 4.0 * scale * math.sqrt(num_clients) + payload_abs
    eps = float(torch.finfo(torch.float32).eps)
    return 8.0 * terms * eps * magnitude


def secure_sum(payloads: torch.Tensor, base_seed: int, round_idx: int,
               scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the centralized protocol on ``payloads (K, ...)``; returns
    ``(aggregate, masked_payloads)``.  The aggregate equals
    ``payloads.sum(0)`` within :func:`cancellation_bound` (raised on
    otherwise); ``masked_payloads`` is what the server observes."""
    K = payloads.shape[0]
    masked = torch.stack([
        mask_payload(payloads[k], base_seed, k, K, round_idx, scale)
        for k in range(K)])
    agg = torch.sum(masked, dim=0)
    raw = torch.sum(payloads.float(), dim=0)
    bound = cancellation_bound(
        K, scale, max(float(torch.max(torch.abs(payloads))), 1.0))
    residual = float(torch.max(torch.abs(agg - raw)))
    if residual > bound:  # a raise, not an assert: must survive python -O
        raise ValueError(
            f"mask cancellation residue {residual:.3e} exceeds the "
            f"documented bound {bound:.3e} (K={K}, scale={scale}) — the "
            "masks did not cancel (mismatched round indices or seeds?)")
    return agg, masked
