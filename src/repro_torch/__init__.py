"""repro_torch — the BSP pattern miner in PyTorch, for one NVIDIA H100.

A port of the JAX package `repro` (which stays the reference): the same
module layout, the same arithmetic, bit-identical results on the same input,
miner count P and lifeline seed.  The P virtual miners share one device as a
leading tensor dimension; the popcount-GEMM that carries every superstep is
a hand-written CUDA kernel (kernels/support_count/csrc/support_count.cu).

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; without a CUDA device they raise instead of carrying on on
the CPU (see `device.resolve_device`).

The package imports torch, numpy and scipy — never jax, and nothing of the
`repro` package.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
