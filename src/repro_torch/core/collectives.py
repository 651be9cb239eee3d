"""The miner dim across processes: which global miners this process holds,
and the few collectives the superstep needs (counterpart of the
psum/ppermute/mesh half of `repro.core.collectives`).

In one process the P virtual miners are the leading dim of every carry
tensor, and the JAX package's collectives over the miners axis become
indexing and dim-0 sums (core/steal.py, core/global_sync.py).  A
`torch.distributed` cluster of N processes splits that dim into N
contiguous blocks: process i holds global miners [i·P/N, (i+1)·P/N), so
global rank = process · P_local + local row, the `Topology` rank mapping
with one "host" per process.  A `MinerGroup` names that block and carries
what crosses processes:

  * `all_gather` — the hunger census [P_local] -> [P] (the loop condition
    and the REQUEST side of a steal both read the global census), the
    steal payloads of a round whose pairs cross processes, and the
    per-miner outputs at the end of a pass;
  * `all_reduce_sum` — the lambda histogram's dim-0 sum and the pass's
    summed outputs (integer sums, so exact in any order).

Every collective stages through CPU tensors and runs over gloo: two ranks
on one card cannot share NCCL, and the superstep already reads the census
back to the host once per step.  The single-process engine takes no
`MinerGroup` at all (`group=None`), so its superstep runs exactly the
ops it ran before.  `calls`/`seconds` count the collectives and their
wall time, staging copies included.
"""

from __future__ import annotations

import time

import torch

__all__ = ["HOSTS_AXIS", "LOCAL_AXIS", "MinerGroup", "process_group"]

#: the JAX package's topo-mesh axis names: a hierarchical schedule's
#: `round_axes` name them, so both packages build equal schedules
HOSTS_AXIS = "hosts"
LOCAL_AXIS = "local"


class MinerGroup:
    """This process's block of the global miner dim in a gloo cluster."""

    def __init__(self, n_miners: int, rank: int, world: int):
        if world < 1 or not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        if n_miners % world:
            raise ValueError(
                f"{n_miners} miners do not split evenly over {world} "
                "processes"
            )
        self.n_miners = int(n_miners)
        self.rank = int(rank)
        self.world = int(world)
        self.n_local = self.n_miners // self.world
        self.lo = self.rank * self.n_local
        self.hi = self.lo + self.n_local
        self.calls = 0
        self.seconds = 0.0

    def _timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out

    def all_gather(self, *xs: torch.Tensor) -> list[torch.Tensor]:
        """[P_local, ...] tensors -> [P, ...] tensors in global rank order,
        each on its input's device, in ONE gloo round trip (the inputs are
        packed into one int64 buffer; every value here fits)."""
        import torch.distributed as dist

        def run():
            flat = torch.cat([x.reshape(-1).to(torch.int64) for x in xs])
            flat = flat.cpu()
            parts = [torch.empty_like(flat) for _ in range(self.world)]
            dist.all_gather(parts, flat)
            out, off = [], 0
            for x in xs:
                n = x.numel()
                full = torch.cat([p[off:off + n].view(x.shape) for p in parts])
                out.append(full.to(device=x.device, dtype=x.dtype))
                off += n
            return out

        return self._timed(run)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise integer sum over the processes, on x's device."""
        import torch.distributed as dist

        def run():
            buf = x.to(torch.int64).cpu().clone()
            dist.all_reduce(buf, op=dist.ReduceOp.SUM)
            return buf.to(device=x.device, dtype=x.dtype)

        return self._timed(run)

    def sum_int(self, v: int) -> int:
        """A host int summed over the processes."""
        return int(self.all_reduce_sum(torch.tensor([int(v)]))[0])


def process_group(n_miners: int) -> MinerGroup | None:
    """The `MinerGroup` of this process in a live `torch.distributed` group
    of more than one process, else None (the single-process engine)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if world == 1:
        return None
    return MinerGroup(n_miners, dist.get_rank(), world)
