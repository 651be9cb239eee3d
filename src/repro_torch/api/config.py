"""Session configuration, split along the algorithm/runtime seam
(counterpart of `repro.api.config`).

`AlgorithmConfig` is *what* to compute (statistical level, min-support
policy, phase staging) — it never appears in a program cache key, because
alpha/min_sup/delta all enter the BSP program as runtime arguments.
`RuntimeConfig` is *how* to run it (batch sizes, caps, kernel, stealing) —
it is hashable and, resolved against a shape bucket, forms the non-shape
half of the cache key.

`RuntimeConfig.resolve(bucket, n_miners, device)` sizes the per-miner
stack as the JAX package does — by items per miner, clamped by stack
memory (`stack_mem_mb`), which scales with the word width W — and resolves
`kernel_impl="auto"` against the session's device (`cuda` on the card,
`ref` on the CPU), so the resolved `EngineConfig` is concrete.  Resolution
uses bucket dims, not exact dims, so same-bucket datasets share programs.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

from repro_torch.core.engine import EngineConfig, resolve_stack_cap
from repro_torch.kernels.support_count.ops import resolve_impl

from .dataset import ShapeBucket

__all__ = ["AlgorithmConfig", "RuntimeConfig"]


@dataclass(frozen=True)
class AlgorithmConfig:
    """What to compute: test statistic, significance level, phase staging."""

    alpha: float = 0.05          # family-wise error rate target
    statistic: str = "fisher"    # repro_torch.stats key: "fisher" | "chi2"
    pipeline: str = "three_phase"  # PIPELINES key: "three_phase" | "fused23"
    min_sup_floor: int = 1       # lower bound on the lambda-derived min_sup


@dataclass(frozen=True)
class RuntimeConfig:
    """How to run it: caps, kernel, stealing.  Hashable — cache-key half."""

    expand_batch: int = 16         # B: nodes popped per miner per superstep
    stack_cap: int | None = None   # CAP; None = auto-size via resolve()
    steal_max: int = 256           # T: max nodes per GIVE
    push_cap: int = 1024           # C: max child pushes per superstep
    out_cap: int = 4096            # pattern-record buffer per miner
    max_steps: int = 100_000
    n_random_perms: int = 4
    seed: int = 0
    steal_enabled: bool = True
    kernel_impl: str = "auto"      # "auto" (cuda on the card, ref on the
    #                                CPU) | "ref" | "cuda"
    #: the JAX Pallas kernel's block triple; the CUDA kernel sizes its own
    #: grid, so this must stay None
    kernel_blocks: tuple[int, int, int] | None = None
    trace_period: int = 0          # superstep trace ring: not ported yet
    trace_cap: int = 0
    sync_period: int = 4           # supersteps between lambda/histogram syncs
    ckpt_period: int = 0           # segmented program: not ported yet
    topology: object | None = None  # multi-host topology: not ported yet
    stack_mem_mb: int = 256        # per-miner stack memory ceiling (resolve())
    # session-level knob (never part of the resolved EngineConfig): programs
    # a MinerSession retains before LRU eviction
    max_programs: int = 64

    @classmethod
    def from_engine_config(cls, cfg: EngineConfig) -> "RuntimeConfig":
        """Adopt an EngineConfig verbatim (stack_cap stays fixed)."""
        return cls(**{f.name: getattr(cfg, f.name) for f in fields(EngineConfig)})

    def with_options(self, **kw) -> "RuntimeConfig":
        return replace(self, **kw)

    def resolve(self, bucket: ShapeBucket, n_miners: int, device) -> EngineConfig:
        """Concrete EngineConfig for one shape bucket on `device`.

        stack_cap default (`core.engine.resolve_stack_cap`): 2 nodes per
        depth-1 root dealt to this miner, floored at 8192, then clamped so
        the per-miner stack — stack_cap * (W + 4) * 4 bytes, W the packed
        word width — stays under `stack_mem_mb`.  The clamp never goes
        below what one superstep can produce (push_cap + steal_max +
        expand_batch).
        """
        if self.kernel_blocks is not None:
            raise ValueError(
                "kernel_blocks: the CUDA kernel sizes its own grid; pass None"
            )
        cfg = EngineConfig(
            expand_batch=self.expand_batch,
            stack_cap=self.stack_cap,
            steal_max=self.steal_max,
            push_cap=self.push_cap,
            out_cap=self.out_cap,
            max_steps=self.max_steps,
            n_random_perms=self.n_random_perms,
            seed=self.seed,
            steal_enabled=self.steal_enabled,
            # "auto" resolves here, per device, so the resolved config (and
            # with it the session's program cache key) is concrete
            kernel_impl=resolve_impl(self.kernel_impl, device),
            kernel_blocks=None,
            trace_period=self.trace_period,
            trace_cap=self.trace_cap,
            sync_period=self.sync_period,
            ckpt_period=self.ckpt_period,
            topology=self.topology,
        )
        return replace(cfg, stack_cap=resolve_stack_cap(
            cfg, bucket.items, bucket.words, n_miners, self.stack_mem_mb))
