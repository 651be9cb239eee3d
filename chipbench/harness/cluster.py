"""Rank 0 of a cluster cell: the harness process and its follower ranks.

A traffic mix with `"driver": "cluster"` and `"processes": N` runs one
query at a time across N processes of one gloo group, each on a card of
its own: the harness process is rank 0 on its first visible card, and
`chipbench/harness/cluster_rank.py` runs ranks 1 .. N-1, rank r seeing
only the r-th of the harness's visible cards (`CUDA_VISIBLE_DEVICES`).
The ranks share the host's cores as the operating system places them:
on an H100 node, pinning each rank to a block of cores of its own
lengthened rank 0's set-up by 8-19 s and made the runs no steadier.

Every rank makes the same inputs from the seed and builds its own
`MinerSession` of the configuration's miners inside the group, so the
session holds its block of them (`repro_torch.core.collectives`).  Before
each request rank 0 broadcasts the request's index, or -1 to stop, and
every follower runs that request of the mix: all ranks run the same
queries in lockstep, and rank 0 alone decides the window.  After the
window each follower sends back its card, its peak of device memory and
the forbidden modules it holds.

A watchdog ends the harness process (exit 4, no result) within a fraction
of a second of a follower's exit before the stop, or of any follower's
failure, with every other follower killed: a dead peer never leaves rank
0 waiting in a collective.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

__all__ = ["EXIT_RANK_LOST", "Leader", "card_id", "cluster_faults"]

ROOT = Path(__file__).resolve().parents[2]
#: the module each follower runs (`python -m`, from the repository's root)
RANK_MODULE = "chipbench.harness.cluster_rank"
#: the harness's exit code when a follower is lost
EXIT_RANK_LOST = 4
#: seconds between the watchdog's looks, and a follower's to exit after the stop
POLL_S = 0.2
JOIN_S = 60.0


def _log(msg: str) -> None:
    print(f"cluster: {msg}", file=sys.stderr, flush=True)


def card_id(device) -> str | None:
    """The UUID of the card `device` names; None on the CPU."""
    import torch

    if device.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(device).uuid)


def cluster_faults(reports: list[dict]) -> list[str]:
    """Why the ranks' reports ({"rank", "card", "peak", "forbidden"}) do
    not stand as one rank to a card, free of JAX; empty where they do."""
    out = []
    by_card: dict = {}
    for r in reports:
        if r["card"] is not None:
            by_card.setdefault(r["card"], []).append(r["rank"])
    out += [f"ranks {ranks} share the card {card}" for card, ranks in by_card.items()
            if len(ranks) > 1]
    out += [f"rank {r['rank']} holds {r['forbidden']}" for r in reports if r["forbidden"]]
    return out


def _visible_cards(world: int) -> list[str]:
    listed = [c for c in os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",") if c.strip()]
    return listed[:world] if len(listed) >= world else [str(r) for r in range(world)]


class Leader:
    """Rank 0 of a cell's process group and the followers it spawned."""

    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.world = int(cell.traffic["processes"])
        self.procs: list[subprocess.Popen] = []
        self._stopping = False
        self._done = threading.Event()

    # ------------------------------------------------------------ set-up
    def start(self) -> None:
        """Spawn ranks 1 .. N-1 and the watchdog."""
        from repro_torch.topo.bootstrap import free_port

        if self.device.type == "cuda":   # the followers load it, never race to build it
            from repro_torch.kernels.support_count.kernel import build

            build()
        self.coordinator = f"127.0.0.1:{free_port()}"
        cards = _visible_cards(self.world)
        for r in range(1, self.world):
            spec = dict(rank=r, world=self.world, coordinator=self.coordinator,
                        seed=self.seed, device=self.device.type, cell=self.cell.name,
                        config=self.cell.config, traffic=self.cell.traffic)
            env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards[r])
            # the follower's output goes to the harness's standard error
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", RANK_MODULE, json.dumps(spec)],
                cwd=ROOT, env=env, stdout=2, stdin=subprocess.DEVNULL))
        threading.Thread(target=self._watch, name="cluster-watchdog", daemon=True).start()

    def join_group(self, t_start: float) -> None:
        """Rank 0 joins the group; returns once every follower has."""
        from repro_torch.topo.bootstrap import init_distributed

        _log(f"rank 0 joins the group at {time.perf_counter() - t_start:.2f} s")
        init_distributed(self.coordinator, self.world, 0)
        _log(f"the group of {self.world} stands at {time.perf_counter() - t_start:.2f} s")

    def _watch(self) -> None:
        while not self._done.wait(POLL_S):
            for r, p in enumerate(self.procs, start=1):
                code = p.poll()
                if code is None or (code == 0 and self._stopping):
                    continue
                _log(f"rank {r} exited with {code} "
                     f"{'after' if self._stopping else 'before'} the stop; ending the run")
                self._kill()
                os._exit(EXIT_RANK_LOST)

    # ------------------------------------------------------------ window
    def announce(self, i: int) -> None:
        """Tell every follower to run request `i` of the mix (-1: stop)."""
        import torch
        import torch.distributed as dist

        dist.broadcast(torch.tensor([int(i)], dtype=torch.int64), src=0)

    def finish(self, own_peak: int) -> list[dict]:
        """Stop the followers and return every rank's report, rank 0's
        (`own_peak`) first; raises where `cluster_faults` finds a fault
        or a follower fails to exit."""
        import torch.distributed as dist

        from ..run import forbidden_modules

        self._stopping = True
        self.announce(-1)
        reports = [None] * self.world
        mine = dict(rank=0, card=card_id(self.device), peak=int(own_peak),
                    forbidden=forbidden_modules())
        dist.gather_object(mine, reports, dst=0)
        dist.destroy_process_group()
        for r, p in enumerate(self.procs, start=1):
            try:
                code = p.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                raise RuntimeError(f"rank {r} did not exit cleanly after the stop ({code})")
        self._done.set()
        _log(f"ranks on cards {[r['card'] for r in reports]}, "
             f"peaks {[r['peak'] for r in reports]}")
        faults = cluster_faults(reports)
        if faults:
            raise RuntimeError("; ".join(faults))
        return reports

    def close(self) -> None:
        """Leave nothing behind: kill any follower still running, leave the
        group (after a failure on the way)."""
        import torch.distributed as dist

        self._done.set()
        self._kill()
        if dist.is_initialized():
            dist.destroy_process_group()

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
