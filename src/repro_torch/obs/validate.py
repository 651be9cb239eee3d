"""Schema validators for the exported observability artifacts (a copy of
`repro.obs.validate`).

CI's slow-system job runs a traced smoke mine and pipes its artifacts
through this module, so a malformed Chrome-trace JSON or Prometheus
exposition snapshot fails the job instead of silently producing files no
viewer or scraper can load::

    python -m repro_torch.obs.validate --chrome trace.json --prom metrics.prom

Both validators raise ``ValueError`` with the offending line/event named;
the test suite reuses them to pin the exporters' formats.
"""

from __future__ import annotations

import argparse
import json
import re

__all__ = ["validate_chrome_trace", "validate_prometheus_text"]

_METRIC_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABELS = r"\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\\n]|\\.)*\")*\}"
_VALUE = r"(?:[+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)|[+-]?Inf|NaN)"
_SAMPLE_RE = re.compile(
    rf"^({_METRIC_NAME})({_LABELS})? ({_VALUE})(?: [+-]?\d+)?$"
)
_TYPE_RE = re.compile(
    rf"^# TYPE ({_METRIC_NAME}) (counter|gauge|histogram|summary|untyped)$"
)
_HELP_RE = re.compile(rf"^# HELP ({_METRIC_NAME}) .*$")


def validate_chrome_trace(obj_or_path) -> int:
    """Validate a Chrome trace-event JSON file/object; returns event count.

    Checks the envelope (``traceEvents`` list) and, per event, the fields
    the Perfetto/chrome://tracing importers require: a string ``name``, a
    one-char ``ph``, numeric ``ts`` (and ``dur`` >= 0 for complete events),
    integer ``pid``/``tid``, and JSON-object ``args`` when present.
    """
    if isinstance(obj_or_path, str):
        with open(obj_or_path) as f:
            obj = json.load(f)
    else:
        obj = obj_or_path
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        raise ValueError("chrome trace: top level must be an object with a "
                         "'traceEvents' list")
    for i, ev in enumerate(obj["traceEvents"]):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            raise ValueError(f"{where}: event must be an object")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"{where}: missing/empty 'name'")
        ph = ev.get("ph")
        if not isinstance(ph, str) or len(ph) != 1:
            raise ValueError(f"{where}: 'ph' must be a 1-char string")
        if not isinstance(ev.get("ts"), (int, float)):
            raise ValueError(f"{where}: 'ts' must be a number (microseconds)")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: complete event needs 'dur' >= 0")
        for key in ("pid", "tid"):
            if key in ev and not isinstance(ev[key], int):
                raise ValueError(f"{where}: '{key}' must be an int")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"{where}: 'args' must be an object")
    return len(obj["traceEvents"])


def validate_prometheus_text(text_or_path) -> int:
    """Validate Prometheus text exposition format 0.0.4; returns sample count.

    Checks line syntax (HELP/TYPE comments, sample lines), that every
    sample's base name was TYPE-declared, and histogram structure: a
    ``+Inf`` bucket per series, cumulative bucket counts, and
    ``_bucket{+Inf} == _count``.
    """
    if "\n" not in text_or_path and text_or_path.endswith((".prom", ".txt")):
        with open(text_or_path) as f:
            text = f.read()
    else:
        text = text_or_path
    types: dict[str, str] = {}
    samples: list[tuple[str, str, float]] = []  # (name, labelstr, value)
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if line.startswith("# TYPE "):
                m = _TYPE_RE.match(line)
                if not m:
                    raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
                types[m.group(1)] = m.group(2)
            elif line.startswith("# HELP "):
                if not _HELP_RE.match(line):
                    raise ValueError(f"line {lineno}: malformed HELP: {line!r}")
            continue  # other comments are legal and ignored
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        samples.append((name, labels, float(value)))
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in types and base not in types:
            raise ValueError(
                f"line {lineno}: sample {name!r} has no preceding TYPE"
            )

    # histogram structure: cumulative buckets ending at +Inf == _count
    hists = [n for n, k in types.items() if k == "histogram"]
    for name in hists:
        series: dict[str, list[tuple[float, float]]] = {}
        counts: dict[str, float] = {}
        for sname, labels, value in samples:
            if sname == f"{name}_bucket":
                mm = re.search(r'le="([^"]*)"', labels)
                if not mm:
                    raise ValueError(f"{name}_bucket sample missing le label")
                rest = re.sub(r',?le="[^"]*"', "", labels)
                bound = float("inf") if mm.group(1) == "+Inf" else float(mm.group(1))
                series.setdefault(rest, []).append((bound, value))
            elif sname == f"{name}_count":
                counts[labels] = value
        for key, buckets in series.items():
            buckets.sort()
            vals = [v for _, v in buckets]
            if vals != sorted(vals):
                raise ValueError(f"{name}{key}: bucket counts not cumulative")
            if buckets[-1][0] != float("inf"):
                raise ValueError(f"{name}{key}: missing +Inf bucket")
            if key in counts and counts[key] != buckets[-1][1]:
                raise ValueError(
                    f"{name}{key}: +Inf bucket {buckets[-1][1]} != _count "
                    f"{counts[key]}"
                )
    return len(samples)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="validate exported observability artifacts"
    )
    ap.add_argument("--chrome", action="append", default=[],
                    help="Chrome-trace JSON file to validate")
    ap.add_argument("--prom", action="append", default=[],
                    help="Prometheus text exposition file to validate")
    args = ap.parse_args(argv)
    if not args.chrome and not args.prom:
        ap.error("nothing to validate: pass --chrome and/or --prom")
    for path in args.chrome:
        n = validate_chrome_trace(path)
        print(f"[ok] {path}: valid chrome trace ({n} events)")
    for path in args.prom:
        with open(path) as f:
            n = validate_prometheus_text(f.read())
        print(f"[ok] {path}: valid prometheus exposition ({n} samples)")


if __name__ == "__main__":
    main()
