"""Test-support machinery shipped with the library (not the test suite).

`repro_torch.testing.faults` (a copy of `repro.testing.faults`) is the
deterministic fault-injection plane used by the port's fault-tolerance
tests, `chip_smoke.py` and `repro_torch.examples.fault_tolerant_mining`
(DESIGN.md §11).  Its plan is its own: a plan installed in the JAX
package's copy does not reach the port's engine, and the reverse.
"""

from .faults import (
    FaultPlan,
    SimulatedFault,
    check,
    clear,
    corrupt_step_dir,
    injected,
    install,
)

__all__ = [
    "FaultPlan",
    "SimulatedFault",
    "check",
    "clear",
    "corrupt_step_dir",
    "injected",
    "install",
]
