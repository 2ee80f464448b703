"""Aggregation-tree topology: who merges whom on the way to role 0.

The star protocol makes role 0 the single merge point for every client's
cut uplink — O(K) FIFO submits, O(K) merge work and O(K) jacobian fan-out
all serialize on one host, which is the scaling wall the ROADMAP names for
"hundreds of clients".  :class:`AggTree` arranges the K feature-holders in
a fanout-F tree rooted at role 0: the first ``min(F, K)`` clients are role
0's direct children (the *top level*), and every other client hangs off an
earlier client, at most F children per node.  Interior clients are
*relays*: each combines the partial sum of its subtree's cut uplinks
(its own cut plus one combined frame per child) before forwarding ONE
frame toward role 0, and symmetrically fans the head jacobian back down —
so role 0 handles ``min(F, K)`` frames per microbatch instead of K.

Partial-sum aggregation is only sound for the additively homomorphic
merges (sum/avg): a K-term sum can be regrouped into subtree partial sums,
and — the Secure Forward Aggregation observation — Bonawitz-style pairwise
masks cancel under ANY partial grouping as long as the final sum at role 0
covers all K clients, so the tree composes with secure aggregation
unchanged.  Non-additive merges (max/mul/concat, program ``merge_fn``) and
cut compression (per-client codec frames cannot be partial-summed) are
rejected loudly through the compat matrix.  The port's engine clocks a
tree (``StepPlan.tree_fanout``); its Executor does not execute one yet and
refuses it by name.

Numerics: regrouping a float32 sum reassociates it, so a tree merge is NOT
bit-identical to the flat ``torch.sum(dim=0)`` — each relay accumulates its
parts in a fixed deterministic order (own cut first, then children in
configured order), which makes the result run-to-run reproducible but
still a different rounding of the same exact sum.  ``TREE_VERIFY_ATOL``
is the documented tolerance for that reassociation residue;
secure aggregation's mask-cancellation residue (~1e-3) dominates it when
both are on.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional

# f32 reassociation tolerance of the tree-grouped sum/avg vs the flat
# merge: at trained-scale cut activations (O(1) magnitudes, K <= ~64) the
# regrouping residue stays well under 1e-5 per element; gradients pass it
# through one more rounding, hence the 2e-5 margin.
TREE_VERIFY_ATOL = 2e-5


@dataclass(frozen=True)
class AggTree:
    """Fanout-F aggregation tree over clients ``0..K-1`` rooted at role 0.

    Layout is breadth-first by client id: clients ``0..min(F,K)-1`` are
    role 0's children (*top level*); client ``i >= F`` hangs off client
    ``(i - F) // F``.  Every node has at most F children, and a client's
    parent always has a smaller id — which is what makes the relay FIFO
    safe: a relay's own ``forward`` for a (step, mb) is submitted in the
    same upfront sweep as its children's, so its accumulator state exists
    by the time any child frame is routed to it (and the accumulator is
    arrival-order-agnostic regardless).

    ``fanout >= num_clients`` degenerates to the star (every client top
    level, no relays) — valid, and useful as the identity case in tests.
    """

    num_clients: int
    fanout: int

    def __post_init__(self):
        if self.num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {self.num_clients}")
        if self.fanout < 2:
            raise ValueError(
                f"aggregation-tree fanout must be >= 2, got {self.fanout} "
                "(fanout 1 is a chain with no aggregation win; use the star "
                "by not passing a tree)")

    # -- structure ------------------------------------------------------------

    def parent(self, client: int) -> Optional[int]:
        """The client this one uplinks to; ``None`` for top-level clients
        (their parent is role 0)."""
        self._check(client)
        if client < self.fanout:
            return None
        return (client - self.fanout) // self.fanout

    def children(self, client: int) -> tuple[int, ...]:
        """Clients whose combined frames this one aggregates (id order —
        the relay's deterministic accumulation order)."""
        self._check(client)
        lo = self.fanout * (client + 1)
        return tuple(range(lo, min(lo + self.fanout, self.num_clients)))

    def subtree(self, client: int) -> tuple[int, ...]:
        """``client`` plus every descendant, preorder — the clients whose
        cuts one combined uplink from ``client`` carries."""
        out = [client]
        for c in self.children(client):
            out.extend(self.subtree(c))
        return tuple(out)

    def edge_level(self, client: int) -> int:
        """Level of the edge from ``client`` to its parent: 0 for the
        top-level edges into role 0, increasing downward."""
        p = self.parent(client)
        return 0 if p is None else 1 + self.edge_level(p)

    @cached_property
    def top_level(self) -> tuple[int, ...]:
        """Role 0's direct children — the only clients whose frames role 0
        receives; ``len(top_level) == min(fanout, num_clients)``."""
        return tuple(range(min(self.fanout, self.num_clients)))

    @cached_property
    def relays(self) -> tuple[int, ...]:
        """Clients with at least one child (they run the ``aggregate`` op)."""
        return tuple(k for k in range(self.num_clients) if self.children(k))

    @cached_property
    def leaves(self) -> tuple[int, ...]:
        return tuple(k for k in range(self.num_clients)
                     if not self.children(k))

    @cached_property
    def depth(self) -> int:
        """Number of edge levels (1 for the star-degenerate tree)."""
        return 1 + max(self.edge_level(k) for k in range(self.num_clients))

    @cached_property
    def is_star(self) -> bool:
        """True when every client is top level (no relays) — the tree path
        then reproduces the star with tree-tagged messages."""
        return not self.relays

    def edges_at_level(self, level: int) -> tuple[int, ...]:
        """Clients whose uplink edge sits at ``level`` (for the per-level
        byte audit: level l carries ``len(edges_at_level(l))`` frames per
        microbatch, each of the uniform cut size)."""
        return tuple(k for k in range(self.num_clients)
                     if self.edge_level(k) == level)

    def _check(self, client: int) -> None:
        if not 0 <= client < self.num_clients:
            raise ValueError(
                f"client {client} out of range for K={self.num_clients}")
