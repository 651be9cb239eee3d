"""Multi-process bring-up and argument/result marshalling (counterpart of
`repro.topo.bootstrap`; DESIGN.md §12).

Three concerns:

1. **Bring-up** — `init_distributed()` starts a `torch.distributed` gloo
   process group at a TCP address (`tcp://127.0.0.1:<port>`).  Gloo, not
   NCCL: the collectives stage through host tensors
   (core/collectives.py), and two ranks on one card cannot share NCCL.

2. **Marshalling** — the engine's root deal is deterministic integer
   work: every process derives the *identical* full deal from the same
   dataset, and `RootDeal.miners` keeps the roots dealt to this process's
   miners (the JAX `globalize_args`).  `fetch_outputs` turns a pass's
   per-process outputs back into the full ones on every process —
   all-gathered per-miner rows, all-reduced sums — so the single-process
   postprocess (and the ResultSet) runs unchanged and identically
   everywhere.

3. **Testability** — `launch_local_cluster` spawns N local processes
   against a 127.0.0.1 rendezvous: each child runs a harness script with
   the cluster coordinates folded into its JSON spec, and the parent
   returns process 0's JSON answer (or every process's).  Multi-process
   code paths run on one machine, and on one card.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

__all__ = [
    "init_distributed",
    "fetch_outputs",
    "OUTPUT_KINDS",
    "free_port",
    "launch_local_cluster",
]


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int) -> None:
    """Join a gloo process group of `num_processes` at
    `coordinator_address` ("host:port" or "tcp://host:port") as rank
    `process_id`.  A collective that waits 5 minutes for a dead peer
    raises instead of hanging."""
    import datetime

    import torch.distributed as dist

    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = f"tcp://{addr}"
    dist.init_process_group(
        "gloo", init_method=addr, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(minutes=5),
    )


# ----------------------------------------------------------- marshalling
#: how each of a pass's outputs (`engine.PassOutput`) combines across
#: processes: "sum" of the processes' partial sums, "rows" of per-miner
#: rows in rank order, or "same" on every process (lambda, supersteps)
OUTPUT_KINDS = dict(hist="sum", lam="same", t="same", stats="rows",
                    out_occ="rows", out_meta="rows", out_ptr="rows",
                    n_sig="sum", trace="rows", hist2d="sum")


def fetch_outputs(raw, group):
    """One process's `PassOutput` -> the full single-process one, identical
    on every process.  Sums are taken in int64 and cast back, so they
    equal the one-process sums bit for bit."""
    if group is None:
        return raw
    out = {}
    for name, kind in OUTPUT_KINDS.items():
        x = getattr(raw, name)
        if kind == "same" or x is None:
            continue
        arr = np.asarray(x)
        t = torch.from_numpy(np.ascontiguousarray(arr).astype(np.int64))
        if kind == "sum":
            t = group.all_reduce_sum(t)
        else:
            (t,) = group.all_gather(t)
        full = t.numpy().astype(arr.dtype)
        out[name] = full if arr.ndim else full.item()
    return raw._replace(**out)


# ------------------------------------------------------- local cluster
def free_port() -> int:
    """An OS-assigned free TCP port on localhost (for the rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local_cluster(
    harness_path: str,
    spec: dict,
    *,
    n_processes: int,
    miners_per_process: int,
    timeout: float = 300.0,
    env: dict | None = None,
    all_processes: bool = False,
):
    """Run `harness_path` as an N-process gloo cluster on this machine.

    Each child gets `spec` plus the cluster coordinates (coordinator,
    num_processes, process_id) and the global miner count `n_miners` as
    its argv[1] JSON.  When the spec runs on the card ("device" absent or
    "cuda") the kernel is built here first, so the children load one
    library instead of racing to compile it.  A child that fails, or a
    cluster still running after `timeout` seconds, kills every child and
    raises with their stderr.  Returns the last stdout line of process 0
    parsed as JSON, or every process's in rank order with `all_processes`.
    """
    if str(spec.get("device", "cuda")).startswith("cuda"):
        from repro_torch.kernels.support_count.kernel import build

        build()
    coordinator = f"127.0.0.1:{free_port()}"
    child_env = dict(os.environ if env is None else env)
    procs = []
    for pid in range(n_processes):
        child_spec = dict(
            spec,
            coordinator=coordinator,
            num_processes=n_processes,
            process_id=pid,
            n_miners=n_processes * miners_per_process,
        )
        procs.append(subprocess.Popen(
            [sys.executable, harness_path, json.dumps(child_spec)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=child_env,
        ))
    outs: list = [None] * n_processes

    def drain(i):  # read each child's pipes as it writes, never blocking it
        outs[i] = procs[i].communicate()

    readers = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(n_processes)]
    for r in readers:
        r.start()
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        while any(r.is_alive() for r in readers):
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a dead rank leaves the others waiting in gloo
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for r in readers:
            r.join()
    if timed_out or any(p.returncode != 0 for p in procs):
        reports = [
            f"process {i} exit {p.returncode}:\n{outs[i][1][-4000:]}"
            for i, p in enumerate(procs)
        ]
        raise RuntimeError(
            f"local cluster ({n_processes}x{miners_per_process}) "
            + (f"timed out after {timeout} s" if timed_out else "failed")
            + ":\n" + "\n".join(reports)
        )
    answers = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
    return answers if all_processes else answers[0]
