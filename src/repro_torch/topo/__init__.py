"""repro_torch.topo — the machine shape as an engine concept (counterpart of
`repro.topo`).

  topology.py   frozen `Topology(n_hosts, devices_per_host)`: detected from
                the `torch.distributed` process group or forced to simulate
                a shape over one process's virtual miners; hashable, so it
                rides the program cache key.
  hierarchy.py  the two-level lifeline schedule: intra-host rounds
                interleaved with cross-host rounds, in the global round
                format `core/steal.py` consumes.
  bootstrap.py  `torch.distributed` (gloo) bring-up, the split of the dealt
                roots over processes and the gather of the outputs, and a
                local subprocess cluster launcher.
  simulate.py   host-side BSP work-stealing simulator over real enumeration
                trees: the paper's scaling model at P in the thousands.

`bootstrap` is imported lazily; the topology model and the schedule
builder import with no side effects.
"""

from .hierarchy import build_hierarchical_schedule
from .topology import Topology, detect_topology

__all__ = ["Topology", "detect_topology", "build_hierarchical_schedule"]
