"""One follower rank of a cluster cell (`harness/cluster.py`).

    python -m chipbench.harness.cluster_rank '<json spec>'

from the repository's root, as rank 0 spawns it: the spec names the rank,
the group's size and address, the seed, the device type, the cell's
configuration and mix.  The rank makes
the cell's inputs from the seed, joins the gloo group, builds its
`MinerSession`, then runs each request whose index rank 0 broadcasts
until it broadcasts -1.  It then sends rank 0 its report (card, peak of
device memory, forbidden modules held) and leaves the group.  It prints
nothing of its own on standard output, and ends itself if rank 0 goes.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _exit_with_parent() -> None:
    """End this process within half a second of rank 0's end, whatever
    this rank is waiting on: no rank outlives its run."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(5)

    threading.Thread(target=watch, name="parent-watch", daemon=True).start()


def main(spec: dict) -> int:
    t_start = time.perf_counter()
    _exit_with_parent()
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    import torch.distributed as dist

    from repro_torch.api import MinerSession
    from repro_torch.device import resolve_device
    from repro_torch.topo.bootstrap import init_distributed

    from chipbench.harness import data
    from chipbench.harness.cell import _datasets, _runtime, _sync_fn
    from chipbench.harness.cluster import card_id
    from chipbench.harness.queries import program_query
    from chipbench.harness.spec import Cell
    from chipbench.run import forbidden_modules

    cell = Cell(name=spec["cell"], config_name="", traffic_name="", chips=spec["world"],
                config=spec["config"], traffic=spec["traffic"], end_to_end=(), per_layer=())
    device = resolve_device(spec["device"])
    inputs = data.make_inputs(cell.config, cell.traffic, spec["seed"])
    datasets = _datasets(cell, inputs, device)
    queries = [program_query(cell.config, p) for p in cell.traffic["params"]]
    print(f"cluster: rank {spec['rank']} joins the group {time.perf_counter() - t_start:.2f} s "
          "after its start", file=sys.stderr, flush=True)
    init_distributed(spec["coordinator"], spec["world"], spec["rank"])
    session = MinerSession(int(cell.config["layout"]["miners"]), device=device,
                           runtime=_runtime(cell))
    sync = _sync_fn(device)
    index = torch.zeros(1, dtype=torch.int64)
    while True:
        dist.broadcast(index, src=0)
        i = int(index[0])
        if i < 0:
            break
        d, q = data.request(cell.traffic, i)
        session.run(datasets[d], queries[q])
        sync()
    del session, datasets
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    report = dict(rank=int(spec["rank"]), card=card_id(device), peak=int(peak),
                  forbidden=forbidden_modules())
    dist.gather_object(report, None, dst=0)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(json.loads(sys.argv[1])))
