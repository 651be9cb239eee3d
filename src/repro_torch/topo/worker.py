"""One process of a local cluster, or one standalone run: mine one query and
print its values as one JSON line (the port's counterpart of the JAX
package's `tests/topo_subproc_main.py`).

    python src/repro_torch/topo/worker.py '<json spec>'

`bootstrap.launch_local_cluster(WORKER, spec, ...)` runs this file once per
process, with the cluster coordinates (coordinator, num_processes,
process_id) and the global miner count `n_miners` folded into the spec;
the process joins the gloo group before it builds anything.  Without
them it runs alone on `n_miners` virtual miners.

The spec: `dataset` ({"paper": name, "scale_items": x} or the fields of a
`SyntheticSpec`), `query` ({"kind": "significant" | "closed-frequent" |
"topk", ...its fields}), `runtime` (RuntimeConfig fields), `topology`
("flat"; "hier" = one host per process, or in one process
[n_hosts, devices_per_host]), `device` ("cuda" by default), `runs` (the
query is run this many times on one warm session; the answer is the last
run's, with every run's wall) and `results_json` (add the ResultSet's
JSON export).  The answer holds the report's values, the ResultSet's
SHA-256, every phase's supersteps, per-miner stats and steal telemetry,
the kernel launches of the last run by (B, M, W) and by (B, M, W, tile),
and the collectives it made.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

WORKER = os.path.abspath(__file__)


def _dataset(data: dict, device):
    from repro_torch.api import Dataset
    from repro_torch.data.synthetic import (
        SyntheticSpec,
        generate,
        paper_problem_packed,
    )

    if "paper" in data:
        bits, labels, _, spec = paper_problem_packed(
            data["paper"], scale_items=data.get("scale_items", 1.0))
        return Dataset.from_packed_words(bits, labels,
                                         n_transactions=spec.n_transactions,
                                         name=spec.name, device=device)
    db, labels, _ = generate(SyntheticSpec(**data))
    return Dataset.from_dense(db, labels, name=data["name"], device=device)


def _query(q: dict):
    from repro_torch import api

    q = dict(q)
    kind = q.pop("kind", "significant")
    return {"significant": api.SignificantPatternQuery,
            "closed-frequent": api.ClosedFrequentQuery,
            "topk": api.TopKSignificantQuery}[kind](**q)


def main(spec: dict) -> dict:
    n_proc = int(spec.get("num_processes", 1))
    if n_proc > 1:
        # the process group first: the session reads it when it is built
        from repro_torch.topo.bootstrap import init_distributed

        init_distributed(spec["coordinator"], n_proc, spec["process_id"])
    import torch

    from repro_torch.api import MinerSession, RuntimeConfig
    from repro_torch.topo import Topology

    device = spec.get("device", "cuda")
    n_miners = int(spec["n_miners"])
    topo = spec.get("topology", "flat")
    if topo == "hier":
        topology = Topology(n_proc, n_miners // n_proc)
    elif topo == "flat":
        topology = None
    else:
        topology = Topology(*topo)
    session = MinerSession(n_miners, device=device, runtime=RuntimeConfig(
        **spec.get("runtime", {}), topology=topology))
    ds = _dataset(spec["dataset"], device)
    query = _query(spec.get("query", {}))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from repro_torch.kernels.support_count import kernel
    walls = []
    for _ in range(int(spec.get("runs", 1))):
        if cuda:
            kernel.reset_counts()
        if session.group is not None:
            session.group.calls, session.group.seconds = 0, 0.0
        t0 = time.perf_counter()
        rep = session.run(ds, query)
        if cuda:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    results_json = rep.results.to_json()
    group = session.group
    out = {
        "process_id": int(spec.get("process_id", 0)),
        "num_processes": n_proc,
        "n_miners": n_miners,
        "miners_here": n_miners if group is None else group.n_local,
        "walls": walls,
        "lambda_final": rep.lambda_final,
        "min_sup": rep.min_sup,
        "correction_factor": rep.correction_factor,
        "delta": rep.delta,
        "n_significant": rep.n_significant,
        "results_sha256": hashlib.sha256(results_json.encode()).hexdigest()[:16],
        "phases": [dict(
            mode=p.mode, supersteps=p.supersteps,
            kernel_blocks=None if p.kernel_blocks is None else list(p.kernel_blocks),
            stats={k: v.tolist() for k, v in p.output.stats.items()},
            steal_by_round=p.steal_by_round, tier_fairness=p.tier_fairness,
        ) for p in rep.phases],
        "launch_shapes": ([[list(k), v] for k, v in sorted(kernel.launch_shapes.items())]
                          if cuda else []),
        "launch_tiles": ([[[*k[:3], list(k[3])], v]
                          for k, v in sorted(kernel.launch_tiles.items())]
                         if cuda else []),
        "collectives": (None if group is None
                        else {"calls": group.calls, "seconds": group.seconds}),
    }
    if spec.get("results_json"):
        out["results_json"] = results_json
    return out


if __name__ == "__main__":
    # run as a script: import the package from this checkout's src/, not
    # this file's own directory
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(WORKER)))
    answer = main(json.loads(sys.argv[1]))
    print(json.dumps(answer))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
