"""Per-link latency/bandwidth and per-host compute-rate model.

The paper's §4.4 placement discussion reasons about one bandwidth number;
real federations are heterogeneous, so the runtime models every client's
uplink/downlink and compute rate independently.  All durations below are
seconds; all sizes are bytes.  The analytic FLOP counts come from
repro_torch.core.costs so the runtime and the paper-table cost model can never
disagree about how much work a step contains.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class LinkModel:
    """One star topology: K clients, each with its own links to role 0."""

    latency_s: tuple[float, ...]  # per-client one-way message latency
    bandwidth_bps: tuple[float, ...]  # per-client link bytes/second
    client_flops_per_s: tuple[float, ...]
    server_flops_per_s: float
    # role-0 NIC serialization rate: every frame role 0 receives or sends
    # ALSO pays num_bytes / server_bandwidth_bps on a shared server-side
    # resource — the wire half of the O(K) star wall the aggregation tree
    # exists to break.  inf (default) keeps the historical behavior where
    # only the per-client links are clocked.
    server_bandwidth_bps: float = float("inf")

    @property
    def num_clients(self) -> int:
        return len(self.latency_s)

    @classmethod
    def uniform(
        cls,
        num_clients: int,
        *,
        latency_s: float = 1e-3,
        bandwidth_bps: float = 1e8,
        client_flops_per_s: float = 5e9,
        server_flops_per_s: float = 5e10,
        server_bandwidth_bps: float = float("inf"),
    ) -> "LinkModel":
        return cls(
            latency_s=(latency_s,) * num_clients,
            bandwidth_bps=(bandwidth_bps,) * num_clients,
            client_flops_per_s=(client_flops_per_s,) * num_clients,
            server_flops_per_s=server_flops_per_s,
            server_bandwidth_bps=server_bandwidth_bps,
        )

    def with_straggler(self, client: int, *, slowdown: float = 10.0) -> "LinkModel":
        """Degrade one client's link AND compute by ``slowdown`` — the
        scenario the no-wait mode exists for."""
        bw = list(self.bandwidth_bps)
        fl = list(self.client_flops_per_s)
        lat = list(self.latency_s)
        bw[client] /= slowdown
        fl[client] /= slowdown
        lat[client] *= slowdown
        return replace(
            self,
            bandwidth_bps=tuple(bw),
            client_flops_per_s=tuple(fl),
            latency_s=tuple(lat),
        )

    def transfer_s(self, client: int, num_bytes: float) -> float:
        """Latency + serialization time for one message on one link."""
        return self.latency_s[client] + num_bytes / self.bandwidth_bps[client]

    def client_compute_s(self, client: int, flops: float) -> float:
        return flops / self.client_flops_per_s[client]

    def server_compute_s(self, flops: float) -> float:
        return flops / self.server_flops_per_s

    def server_transfer_s(self, num_bytes: float) -> float:
        """Role-0 NIC serialization for one frame (0.0 at the default
        infinite rate — link latency is already paid on the client link)."""
        if self.server_bandwidth_bps == float("inf"):
            return 0.0
        return num_bytes / self.server_bandwidth_bps
