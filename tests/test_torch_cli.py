"""The port's launcher (`python -m repro_torch.launch.mine`) against the JAX
package's (`python -m repro.launch.mine`).

The JAX launcher runs in a subprocess, because `--devices N` forces the
simulated device count before JAX starts; the port's runs in-process on
the CPU (`--device cpu`), with `--devices N` as N virtual miners.  Their
JSON blobs must be equal, wall time aside.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mine as tmine  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROBLEM = ["--problem", "hapmap_dom_10", "--scale-items", "0.005"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side, and
    torch's default of one thread per core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_launches(tmp_path_factory):
    """The JAX launcher once per (pipeline, devices) case, all started
    together in their own processes: {case: (process, blob path)}."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = tmp_path_factory.mktemp("jax")
    runs = {}
    for case in CASES:
        path = out / f"{case[0]}_{case[1]}.json"
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro.launch.mine", *_args(*case),
             "--json-out", str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        runs[case] = (proc, path)
    yield runs
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


CASES = [(p, d) for p in ("three_phase", "fused23") for d in (1, 4)]


def _args(pipeline: str, devices: int) -> list[str]:
    return PROBLEM + ["--devices", str(devices), "--pipeline", pipeline]


def _blob(path) -> dict:
    with open(path) as f:
        out = json.load(f)
    out.pop("wall_s")
    return out


@pytest.mark.parametrize("case", CASES, ids=[f"{p}-{d}" for p, d in CASES])
def test_blob_matches_jax_launcher(case, jax_launches, tmp_path, capsys):
    pipeline, devices = case
    port_out = tmp_path / "port.json"
    tmine.main(_args(pipeline, devices) + ["--device", "cpu", "--json-out",
                                           str(port_out)])
    proc, jax_out = jax_launches[case]
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    want, got = _blob(jax_out), _blob(port_out)
    assert got == want
    assert len(got["per_device_popped"]) == devices
    assert (got["steals"] > 0) == (devices > 1)
    # the printed report is the JAX launcher's too, wall time aside
    printed = capsys.readouterr().out
    assert printed.split("{")[0] == stdout.split("{")[0]
    assert printed.split("}")[-1] == stdout.split("}")[-1]


@pytest.mark.parametrize("flags, item", [
    (["--trace-period", "1"], "item 7"),
    (["--trace-cap", "64"], "item 7"),
    (["--ckpt-dir", "ck", "--ckpt-period", "2"], "item 8"),
    (["--resume", "ck"], "item 8"),
    (["--hosts", "2", "--devices-per-host", "2"], "item 10"),
])
def test_unported_flags_exit_naming_their_item(flags, item, capsys):
    with pytest.raises(SystemExit) as exc:
        tmine.main(PROBLEM + ["--device", "cpu"] + flags)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"ROADMAP.md queue 1, {item}" in err


def test_default_device_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tmine.main(PROBLEM)


@pytest.mark.parametrize("query", [
    ["--query", "closed-frequent", "--min-sup", "20"],
    ["--query", "topk", "--k", "3", "--stat", "chi2"],
    ["--stat", "chi2", "--pipeline", "fused23", "--kernel", "ref", "--no-steal"],
])
def test_port_launcher_queries_and_artifacts(query, tmp_path, capsys):
    out = tmp_path / "blob.json"
    trace, prom, pats = (tmp_path / n for n in ("t.json", "m.prom", "p.tsv"))
    tmine.main(PROBLEM + ["--device", "cpu", "--devices", "2", "--verbose",
                          "--json-out", str(out), "--trace-out", str(trace),
                          "--metrics-out", str(prom), "--patterns-out", str(pats)]
               + query)
    blob = json.load(open(out))
    captured = capsys.readouterr()
    records = [json.loads(line) for line in captured.err.splitlines()
               if line.startswith("{")]
    assert [r["event"] for r in records][0] == "data"
    assert records[-1]["event"] == "run" and records[-1]["cache"]["misses"] >= 1
    assert blob["patterns"] == len(pats.read_text().splitlines()) - 1
    assert "miner_query_seconds" in prom.read_text()
    assert any(e["name"] == "query:" + {"closed-frequent": "ClosedFrequentQuery",
                                        "topk": "TopKSignificantQuery"}.get(
        blob["query"], "SignificantPatternQuery")
        for e in json.load(open(trace))["traceEvents"])
    assert blob["statistic"] == (None if blob["query"] == "closed-frequent"
                                 else "chi2")
