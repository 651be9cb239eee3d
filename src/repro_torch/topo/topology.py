"""The machine shape: hosts x devices-per-host, frozen and hashable
(counterpart of `repro.topo.topology`).

A `Topology` answers one question for the rest of the system: which global
miner ranks share a host (cheap steals) and which do not (expensive ones).
Global rank is row-major over [n_hosts, devices_per_host]:

    rank = host * devices_per_host + local

which matches both a `torch.distributed` cluster (process i holds the i-th
contiguous block of global miners, core/collectives.py) and one process
*simulating* a multi-host shape over its P virtual miners ("forced" mode).
The dataclass is frozen and hashable on purpose: it lands in
`EngineConfig`/`RuntimeConfig`, so flat and hierarchical programs can
never collide in a session's program cache.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Topology", "detect_topology"]


@dataclass(frozen=True)
class Topology:
    """`n_hosts` x `devices_per_host` grid of miners, row-major global rank."""

    n_hosts: int
    devices_per_host: int

    def __post_init__(self):
        if self.n_hosts < 1 or self.devices_per_host < 1:
            raise ValueError(
                f"topology needs n_hosts >= 1 and devices_per_host >= 1, got "
                f"({self.n_hosts}, {self.devices_per_host})"
            )

    @property
    def n_proc(self) -> int:
        """Total miner count P = n_hosts * devices_per_host."""
        return self.n_hosts * self.devices_per_host

    # ------------------------------------------------------- rank arithmetic
    def host_of(self, rank: int) -> int:
        """Which host owns global miner `rank`."""
        self._check_rank(rank)
        return rank // self.devices_per_host

    def local_of(self, rank: int) -> int:
        """`rank`'s intra-host position (0..devices_per_host-1)."""
        self._check_rank(rank)
        return rank % self.devices_per_host

    def rank_of(self, host: int, local: int) -> int:
        """Global rank of (host, local) — inverse of host_of/local_of."""
        if not (0 <= host < self.n_hosts):
            raise ValueError(f"host {host} outside [0, {self.n_hosts})")
        if not (0 <= local < self.devices_per_host):
            raise ValueError(
                f"local rank {local} outside [0, {self.devices_per_host})"
            )
        return host * self.devices_per_host + local

    def same_host(self, rank_a: int, rank_b: int) -> bool:
        return self.host_of(rank_a) == self.host_of(rank_b)

    def _check_rank(self, rank: int) -> None:
        if not (0 <= rank < self.n_proc):
            raise ValueError(f"rank {rank} outside [0, {self.n_proc})")

    def __str__(self) -> str:  # "2x4" — compact for labels and cache keys
        return f"{self.n_hosts}x{self.devices_per_host}"


def detect_topology(n_miners: int | None = None) -> Topology:
    """The running process layout, from `torch.distributed`.

    Multi-process (after `bootstrap.init_distributed`): one "host" per
    process, each holding its share of the `n_miners` global miners (an
    even split; default one miner per process).  Single-process: a
    1 x n_miners topology — callers simulating a multi-host shape on one
    process construct `Topology(n_hosts, devices_per_host)` directly
    instead ("forced" mode).
    """
    import torch.distributed as dist

    n_proc = (dist.get_world_size()
              if dist.is_available() and dist.is_initialized() else 1)
    if n_miners is None:
        n_miners = n_proc
    if n_miners % n_proc:
        raise ValueError(
            f"{n_miners} miners do not split evenly over {n_proc} processes"
        )
    return Topology(n_hosts=n_proc, devices_per_host=n_miners // n_proc)
