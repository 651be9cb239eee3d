"""The operation cost of a PyTorch function, counted as it runs
(counterpart of `repro.launch.hlo_cost`).

The JAX package parses the compiled XLA HLO text, where a while loop's body
appears once and its trip count has to be read off the loop condition.
The port has no HLO: `count_costs(fn, *args, **kw)` runs `fn` under a
`TorchDispatchMode` and adds up every aten op it executes, so every
superstep that really runs is counted and trip counts need no parsing.
It returns the JAX parser's keys, `flops`, `bytes`, `coll_payload`
({kind: bytes}) and `coll_link_bytes`, plus `bit_ops`, `ops` (aten ops
executed) and `by_op` ({op: {count, flops, bytes}}).

Conventions, carried over from `hlo_cost.py`:

  * FLOPs of the matmul-class ops (mm, addmm, bmm, baddbmm, convolutions,
    attention) are `torch.utils.flop_counter`'s formulas; other ops count
    bytes only.
  * Bytes are operand plus result bytes per op.  Views, reshapes and
    aliasing ops cost 0, like `bitcast` and `get-tuple-element`, and so do
    bare allocations (`empty`).  An indexed write (`index_put_`,
    `scatter_`, `index_add_`, ...) costs twice its update window, like
    `dynamic-update-slice`; an indexed read (`index`, `gather`,
    `index_select`) twice its result, like `gather`; a `copy_` its source
    plus its destination.
  * Collectives (`MinerGroup`'s gloo all-gathers and all-reduces reach the
    dispatcher as `c10d` ops) count their payload, the gathered result of
    an all-gather and the operand of the rest, and the ring convention's
    link bytes: 2(G-1)/G payloads for an all-reduce, (G-1)/G for the rest,
    G the group size.  Values are per process, as JAX's are per device.

The support count is one work item per call of the three entries of
`kernels/support_count/ops.py`: bytes (M·W + B·W + B·M)·4 and bit
operations 2·B·M·32W (the same formula as chip_smoke.py's bound), filed
under `by_op["support_count"]`.  Inside that call the dispatch mode is
suspended, so the report is the same whether the plain version or the CUDA
kernel computes it.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["count_costs", "counting", "support_count_item"]

_aten = torch.ops.aten
#: allocations that touch no memory
_ALLOC = {_aten.empty.memory_format, _aten.empty_like.default,
          _aten.empty_strided.default, _aten._unsafe_view.default}
#: indexed writes: {op: index of the update-window argument}
_INDEXED_WRITES = {
    _aten.index_put_.default: 2, _aten.index_put.default: 2,
    _aten._index_put_impl_.default: 2,
    _aten.scatter_.src: 3, _aten.scatter.src: 3,
    _aten.scatter_add_.default: 3, _aten.scatter_add.default: 3,
    _aten.scatter_reduce_.two: 3, _aten.scatter_reduce.two: 3,
    _aten.index_add_.default: 3, _aten.index_add.default: 3,
    _aten.index_copy_.default: 3, _aten.index_copy.default: 3,
}
#: indexed reads, charged twice their result
_INDEXED_READS = {_aten.index.Tensor, _aten.gather.default,
                  _aten.index_select.default, _aten.take.default}

_state = threading.local()


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.bit_ops = 0.0
        self.ops = 0
        self.coll_payload: dict[str, float] = defaultdict(float)
        self.coll_link = 0.0
        self.by_op: dict[str, dict] = defaultdict(
            lambda: {"count": 0, "flops": 0.0, "bytes": 0.0})
        self.inside_item = False

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        row = self.by_op[name]
        row["count"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func)
        if func.namespace == "c10d":
            self._collective(func, args, out)
            self._add(name, 0.0, _bytes(args) + _bytes(out))
            return out
        self.ops += 1
        if func.is_view or func in _ALLOC:
            nbytes = 0
        elif func in _INDEXED_WRITES:
            nbytes = 2 * _bytes(args[_INDEXED_WRITES[func]])
        elif func in _INDEXED_READS:
            nbytes = 2 * _bytes(out)
        elif func is _aten.copy_.default:
            nbytes = _bytes(args[0]) + _bytes(args[1])
        else:
            nbytes = _bytes(args) + _bytes(kwargs) + _bytes(out)
        formula = flop_registry.get(func._overloadpacket)
        flops = float(formula(*args, **kwargs, out_val=out)) if formula else 0.0
        self._add(name, flops, nbytes)
        return out

    def _collective(self, func, args, out) -> None:
        kind = func._schema.name.split("::")[-1].rstrip("_")
        groups = [a for a in args if hasattr(a, "size") and not isinstance(a, (torch.Tensor, list))]
        if kind.startswith("allgather"):
            payload = _bytes(args[0])            # the gathered outputs
            g = len(args[0][0]) if args[0] and isinstance(args[0][0], list) else 0
        else:
            payload = _bytes(args[0])
            g = 0
        if not g and groups:
            g = int(groups[0].size())
        g = max(g, 2)
        factor = 2.0 * (g - 1) / g if kind.startswith("allreduce") else (g - 1) / g
        self.coll_payload[kind] += payload
        self.coll_link += payload * factor

    def item(self, name: str, nbytes: float, bit_ops: float) -> None:
        self._add(name, 0.0, nbytes)
        self.by_op[name].setdefault("bit_ops", 0.0)
        self.by_op[name]["bit_ops"] += bit_ops
        self.bit_ops += bit_ops

    def report(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "coll_payload": dict(self.coll_payload),
            "coll_link_bytes": self.coll_link,
            "bit_ops": self.bit_ops,
            "ops": self.ops,
            "by_op": {k: dict(v) for k, v in self.by_op.items()},
        }


def count_costs(fn, *args, **kw) -> dict:
    """Run fn(*args, **kw) once, counting every aten op it executes in this
    thread; the cost report (see the module doc)."""
    rec = _Recorder()
    prev = getattr(_state, "recorder", None)
    _state.recorder = rec
    try:
        with rec:
            fn(*args, **kw)
    finally:
        _state.recorder = prev
    return rec.report()


def counting() -> bool:
    """True inside `count_costs` in this thread: the engine then runs its
    supersteps eagerly, since a CUDA graph's replay dispatches no op."""
    return getattr(_state, "recorder", None) is not None


@contextmanager
def support_count_item(b: int, m: int, w: int):
    """One support-count call of [B, W] x [M, W]: recorded as a work item
    of the active `count_costs` in this thread, with its dispatch mode
    suspended around the body; nothing at all without one (or nested in
    another item)."""
    rec = getattr(_state, "recorder", None)
    if rec is None or rec.inside_item:
        yield
        return
    rec.item("support_count", (m * w + b * w + b * m) * 4, 2 * b * m * 32 * w)
    rec.inside_item = True
    try:
        with _disable_current_modes():
            yield
    finally:
        rec.inside_item = False
