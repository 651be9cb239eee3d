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
`ref` on the CPU) and `kernel_blocks=None` to the autotuner's tile for the
superstep's support count (`kernels/support_count/autotune.py`), so the
resolved `EngineConfig`, and with it the program cache key, is concrete.
Resolution uses bucket dims, not exact dims, so same-bucket datasets share
programs.
`trace_period` and `ckpt_period` pass through into the resolved config, so
sessions of other trace or segment lengths never share a program.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

from repro_torch.core.engine import EngineConfig, resolve_stack_cap
from repro_torch.kernels.support_count import autotune
from repro_torch.kernels.support_count.ops import resolve_impl
from repro_torch.obs.trace import DEFAULT_TRACE_CAP

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
    #: the CUDA kernel's (block_b, block_m, block_w) tile (occ rows per
    #: block, items per ring tile, K words per unit; autotune.py); None =
    #: let the autotuner choose for the superstep's exact launch shape at
    #: resolve time — the resolved tile joins the program cache key
    kernel_blocks: tuple[int, int, int] | None = None
    #: superstep trace sampling period (DESIGN.md §9): 0 = tracing off;
    #: k > 0 records one TraceField row every k-th superstep
    trace_period: int = 0
    trace_cap: int = 0             # trace ring slots; 0 = default when tracing
    sync_period: int = 4           # supersteps between lambda/histogram syncs
    #: checkpoint cadence (DESIGN.md §11): 0 = a pass of one segment;
    #: k > 0 runs segments of k supersteps, enabling frontier
    #: checkpoint/resume and cooperative soft deadlines
    ckpt_period: int = 0
    #: machine shape (repro_torch.topo): None = the flat lifeline
    #: schedule; a Topology selects the hierarchical two-level one.
    #: Hashable, so it lands in the resolved EngineConfig and the program
    #: cache key: flat and hierarchical programs never collide.
    topology: object | None = None
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

    def resolve(self, bucket: ShapeBucket, n_miners: int, device,
                n_local: int | None = None) -> EngineConfig:
        """Concrete EngineConfig for one shape bucket on `device`.

        kernel_blocks: an explicit tile must be a candidate of the
        superstep's launch, (n_local * expand_batch, bucket items, bucket
        words), `n_local` being this process's miners (default all
        `n_miners`); None becomes `autotune.choose_blocks` there when the
        kernel runs (`cuda`) and stays None for the plain version.

        stack_cap default (`core.engine.resolve_stack_cap`): 2 nodes per
        depth-1 root dealt to this miner, floored at 8192, then clamped so
        the per-miner stack — stack_cap * (W + 4) * 4 bytes, W the packed
        word width — stays under `stack_mem_mb`.  The clamp never goes
        below what one superstep can produce (push_cap + steal_max +
        expand_batch).
        """
        impl = resolve_impl(self.kernel_impl, device)
        launch = ((n_miners if n_local is None else n_local) * self.expand_batch,
                  bucket.items, bucket.words)
        blocks = self.kernel_blocks
        if blocks is not None:
            blocks = autotune.check_blocks(blocks, *launch)
        elif impl == "cuda":
            card, sms = autotune.card_info(device)
            blocks = autotune.choose_blocks(*launch, impl, card=card, sms=sms)
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
            # "auto" impl and None blocks resolve here, per device and
            # bucket, so the resolved config (and with it the session's
            # program cache key) is concrete
            kernel_impl=impl,
            kernel_blocks=blocks,
            trace_period=self.trace_period,
            # tracing on with no explicit ring size: supply the default cap
            trace_cap=(
                self.trace_cap
                if self.trace_cap or not self.trace_period
                else DEFAULT_TRACE_CAP
            ),
            sync_period=self.sync_period,
            ckpt_period=self.ckpt_period,
            topology=self.topology,
        )
        return replace(cfg, stack_cap=resolve_stack_cap(
            cfg, bucket.items, bucket.words, n_miners, self.stack_mem_mb))
