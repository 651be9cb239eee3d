"""Metrics registry — counters, gauges, histograms with Prometheus exposition.

A copy of `repro.obs.metrics` (stdlib only): cumulative run-state a process
can snapshot at any time, as opposed to the per-span host timeline.  The
Prometheus *text exposition format* is the interface, so anything that
scrapes .prom files can consume it without a client library::

    reg = MetricsRegistry()
    hits = reg.counter("cache_hits_total", "program cache hits")
    lat = reg.histogram("query_seconds", "query latency", labels=("query",))
    hits.inc()
    lat.labels(query="significant").observe(0.12)
    print(reg.expose_text())

`MinerSession` owns a registry by default and feeds it the program-cache
hit/miss/eviction counters, per-phase and per-query latency histograms and
the emit_dropped counter; `launch.mine --metrics-out` snapshots it.
Instruments are re-entrant: requesting an existing name returns the same
family (mismatched kind/labels raise).
"""

from __future__ import annotations

import math
import threading

__all__ = [
    "Counter",
    "DEFAULT_LATENCY_BUCKETS",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]

#: log-ish spread from 1 ms to 1 min — mining phase/query latencies span
#: cold compiles (seconds) to warm dispatches (milliseconds)
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc({amount}))")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Settable value."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``le`` semantics)."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets=DEFAULT_LATENCY_BUCKETS):
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative_counts(self) -> list[int]:
        """Per-bound cumulative counts, ending with the +Inf total."""
        out, acc = [], 0
        with self._lock:
            for c in self._counts:
                acc += c
                out.append(acc)
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

_NAME_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid metric name {name!r}")
    return name


class _Family:
    """One named metric: either a single child () or per-label children."""

    __slots__ = ("name", "help", "kind", "labelnames", "_children", "_kwargs",
                 "_lock")

    def __init__(self, name, help_, kind, labelnames, **kwargs):
        self.name = _check_name(name)
        self.help = help_
        self.kind = kind
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, object] = {}
        self._kwargs = kwargs
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = _KINDS[kind](**kwargs)

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{tuple(kv)}"
            )
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _KINDS[self.kind](**self._kwargs)
            return child

    @property
    def default(self):
        """The unlabelled child (only for label-free families)."""
        return self._children[()]

    def children(self):
        with self._lock:
            return dict(self._children)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(value: float) -> str:
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _labelstr(names, values, extra=()):
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class MetricsRegistry:
    """A named set of metric families with text exposition."""

    def __init__(self):
        self._families: dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _family(self, name, help_, kind, labels, **kwargs) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {fam.labelnames}"
                    )
                return fam
            fam = _Family(name, help_, kind, labels, **kwargs)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels=()):
        """A counter (or, with labels, a family — call .labels(...) on it)."""
        fam = self._family(name, help, "counter", labels)
        return fam if labels else fam.default

    def gauge(self, name: str, help: str = "", labels=()):
        fam = self._family(name, help, "gauge", labels)
        return fam if labels else fam.default

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=DEFAULT_LATENCY_BUCKETS):
        fam = self._family(name, help, "histogram", labels, buckets=buckets)
        return fam if labels else fam.default

    def expose_text(self) -> str:
        """Prometheus text exposition format 0.0.4 snapshot."""
        lines = []
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        for fam in families:
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in sorted(fam.children().items()):
                if fam.kind in ("counter", "gauge"):
                    lines.append(
                        f"{fam.name}{_labelstr(fam.labelnames, key)} "
                        f"{_fmt(child.value)}"
                    )
                else:  # histogram
                    cum = child.cumulative_counts()
                    for bound, c in zip(child.buckets, cum):
                        le = _labelstr(fam.labelnames, key,
                                       extra=[("le", _fmt(bound))])
                        lines.append(f"{fam.name}_bucket{le} {c}")
                    inf = _labelstr(fam.labelnames, key, extra=[("le", "+Inf")])
                    lines.append(f"{fam.name}_bucket{inf} {cum[-1]}")
                    ls = _labelstr(fam.labelnames, key)
                    lines.append(f"{fam.name}_sum{ls} {_fmt(child.sum)}")
                    lines.append(f"{fam.name}_count{ls} {child.count}")
        return "\n".join(lines) + "\n"
