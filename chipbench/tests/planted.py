"""Faults planted under a cluster cell's timed path, in every rank.

The test's own process (rank 0) calls `plant`; each follower runs this
module in place of `chipbench.harness.cluster_rank`
(`cluster.RANK_MODULE`), planting the fault that `FAULT_ENV` names
before it runs the rank:

- "answer_altered": the first pattern of every result set gets one more
  support, where the answer is produced;
- "half_batch": the support counts of the second half of each EXPAND
  batch read 0;
- "no_exchange": what the exchange of a pass's outputs brings from the
  other processes is left out (`bootstrap.fetch_outputs` still runs its
  collectives, so no rank waits on another): each process keeps its own
  miners' rows, the others' zeroed, and its own partial sums;
- "same_card": the rank reports the card every other rank reports;
- "hold_jax" (followers only): the rank finds `jax` among its modules
  after the window;
- "die" (followers only): the rank kills itself at its third request.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys

FAULT_ENV = "CHIPBENCH_PLANTED"
#: faults planted in the followers alone
FOLLOWERS_ONLY = ("hold_jax", "die")


def _altered(build):
    def build_result_set(*args, **kw):
        res = build(*args, **kw)
        if res.patterns:
            p = res.patterns[0]
            res.patterns[0] = dataclasses.replace(p, support=p.support + 1)
        return res
    return build_result_set


def _half_batch(count):
    def support_counts_tiled(occ, db_tiles, **kw):
        s = count(occ, db_tiles, **kw)
        s[s.shape[0] // 2:] = 0
        return s
    return support_counts_tiled


def _own_outputs(fetch, kinds):
    import numpy as np

    def fetch_outputs(raw, group):
        full = fetch(raw, group)
        if group is None:
            return full
        own = {}
        for name, kind in kinds.items():
            x, mine = getattr(full, name), getattr(raw, name)
            if x is None or kind == "same":
                continue
            if kind == "sum":
                own[name] = mine
            else:
                n = np.asarray(mine).shape[0]
                y = np.zeros_like(x)
                y[group.rank * n:(group.rank + 1) * n] = mine
                own[name] = y
        return full._replace(**own)
    return fetch_outputs


def _dies(request):
    def dying_request(traffic, i):
        if i >= 2:
            os.kill(os.getpid(), signal.SIGKILL)
        return request(traffic, i)
    return dying_request


def plant(fault: str, set_attr=setattr) -> None:
    """Plant `fault` in this process, through `set_attr(obj, name, value)`."""
    import repro_torch.core.expand as expand
    import repro_torch.results as results
    from repro_torch.topo import bootstrap

    from chipbench import run
    from chipbench.harness import cluster, data

    if fault == "answer_altered":
        set_attr(results, "build_result_set", _altered(results.build_result_set))
    elif fault == "half_batch":
        set_attr(expand, "support_counts_tiled", _half_batch(expand.support_counts_tiled))
    elif fault == "no_exchange":
        set_attr(bootstrap, "fetch_outputs",
                 _own_outputs(bootstrap.fetch_outputs, bootstrap.OUTPUT_KINDS))
    elif fault == "same_card":
        set_attr(cluster, "card_id", lambda device: "GPU-the-same")
    elif fault == "hold_jax":
        set_attr(run, "forbidden_modules", lambda: ["jax"])
    elif fault == "die":
        set_attr(data, "request", _dies(data.request))
    else:
        raise ValueError(f"no fault {fault!r}")


if __name__ == "__main__":
    from chipbench.harness import cluster_rank

    sys.path[:0] = [str(cluster_rank.ROOT / "src")]
    plant(os.environ[FAULT_ENV])
    sys.exit(cluster_rank.main(json.loads(sys.argv[1])))
