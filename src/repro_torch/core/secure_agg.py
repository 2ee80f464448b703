"""Secure aggregation — the port's copy of the one contract it needs so
far: the wire size of a public key-exchange value, which the byte model
(``costs.key_exchange_bytes``) and the engine's step plans price.

The masked protocol itself (the pairwise key agreement, the masks, the
masked merge) is not ported yet; every layer that would run it refuses it
by name (``core.protocol._reject_unported``).
"""
from __future__ import annotations

# placeholder DH group of the JAX package: the multiplicative group mod
# the Mersenne prime M521, so a public value is ceil(521 / 8) bytes
KEYX_GROUP_BYTES = 66
