"""The JAX side of the port's P > 1 comparisons, run in a subprocess.

JAX fixes its device count when it first starts, and the pytest process has
one CPU device; so a test that needs the JAX package at P = 8 runs this
file as a script, with `XLA_FLAGS` forcing P simulated devices, as
tests/engine_subproc_main.py does for the JAX package's own tests.  It
holds no tests.

    python tests/test_torch_jax_worker.py '<json spec>'   -> one JSON line

The spec names a dataset, a RuntimeConfig (its `topology` as
[n_hosts, devices_per_host]) and a query, and optionally a checkpoint
directory to write (`ckpt_dir`), one to resume from
(`resume_from`), an injected kill after N segments (`die_after_segments`)
and a soft stop after N polls (`stop_after`).  The answer holds the
report's values, the ResultSet's JSON export, every phase's per-miner
stats, steal telemetry and decoded trace, and the SHA-256 of every frontier step written (`frontier_digest`).
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from chip_smoke import TRACE_ARRAYS, step_digests, trace_digest  # noqa: E402


def main(spec: dict) -> dict:
    import jax

    import repro.api as api
    from repro.ckpt.mining import load_frontier
    from repro.core.engine import CARRY_FIELDS
    from repro.data.synthetic import SyntheticSpec, generate, paper_problem_packed
    from repro.testing import FaultPlan, SimulatedFault, injected

    data = spec["dataset"]
    if "paper" in data:
        bits, labels, _, pspec = paper_problem_packed(
            data["paper"], scale_items=data.get("scale_items", 1.0))
        ds = api.Dataset.from_packed_words(bits, labels,
                                           n_transactions=pspec.n_transactions,
                                           name=pspec.name)
    else:
        db, labels, _ = generate(SyntheticSpec(**data))
        ds = api.Dataset.from_dense(db, labels, name=data["name"])
    q = dict(spec.get("query", {}))
    kind = q.pop("kind", "significant")
    query = {"significant": api.SignificantPatternQuery,
             "closed-frequent": api.ClosedFrequentQuery,
             "topk": api.TopKSignificantQuery}[kind](**q)
    runtime = dict(spec.get("runtime", {}))
    if runtime.get("topology") is not None:
        from repro.topo import Topology

        runtime["topology"] = Topology(*runtime["topology"])
    session = api.MinerSession(jax.devices(), runtime=api.RuntimeConfig(**runtime))
    polls = {"n": 0}

    def should_stop():
        polls["n"] += 1
        return polls["n"] > spec["stop_after"]

    kw = dict(ckpt_dir=spec.get("ckpt_dir"), resume_from=spec.get("resume_from"),
              should_stop=should_stop if "stop_after" in spec else None)
    out = {"n_devices": len(jax.devices())}
    try:
        if "die_after_segments" in spec:
            with injected(FaultPlan(die_after_segments=spec["die_after_segments"])):
                rep = session.run(ds, query, **kw)
        else:
            rep = session.run(ds, query, **kw)
    except SimulatedFault as e:
        out["killed"] = str(e)
    else:
        out.update(
            lambda_final=rep.lambda_final, min_sup=rep.min_sup,
            correction_factor=rep.correction_factor, delta=rep.delta,
            n_significant=rep.n_significant, partial=rep.partial,
            ckpt_path=rep.ckpt_path, results_json=rep.results.to_json(),
            complete=rep.results.complete,
            phases=[dict(mode=p.mode, supersteps=p.supersteps,
                         resumed=p.resumed, ckpt_writes=p.ckpt_writes,
                         ckpt_bytes=p.ckpt_bytes, trace_dropped=p.trace_dropped,
                         stats={k: np.asarray(v).tolist()
                                for k, v in p.output.stats.items()},
                         steal_by_round=p.steal_by_round,
                         tier_fairness=p.tier_fairness,
                         trace=None if p.trace is None else {
                             f: np.asarray(getattr(p.trace, f)).tolist()
                             for f in TRACE_ARRAYS})
                    for p in rep.phases],
        )
        traces = [p.trace for p in rep.phases if p.trace is not None]
        if traces:
            out["trace_digest"] = trace_digest(traces)
    if spec.get("ckpt_dir"):
        out["frontier_digest"] = step_digests(spec["ckpt_dir"], load_frontier,
                                              CARRY_FIELDS)
    return out


def spawn_jax(spec: dict, n_devices: int):
    """Start `main(spec)` in a subprocess of this file with n_devices JAX
    devices; `collect` its answer."""
    import subprocess

    from repro.core.collectives import host_device_count_env

    env = host_device_count_env(n_devices)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(HERE), "src")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), json.dumps(spec)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def collect(proc, timeout: int = 900) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"stderr:\n{err[-4000:]}"
    return json.loads(out.strip().splitlines()[-1])


def run_jax(spec: dict, n_devices: int, timeout: int = 900) -> dict:
    """`main(spec)` in a subprocess with n_devices JAX devices."""
    return collect(spawn_jax(spec, n_devices), timeout)


if __name__ == "__main__":
    print(json.dumps(main(json.loads(sys.argv[1]))))
