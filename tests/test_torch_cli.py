"""The port's launchers (`python -m repro_torch.launch.mine` and
`.mine_serve`) against the JAX package's (`python -m repro.launch.mine`
and `.mine_serve`).

The JAX launcher runs in a subprocess, because `--devices N` forces the
simulated device count before JAX starts; the port's runs in-process on
the CPU (`--device cpu`), with `--devices N` as N virtual miners.  Their
JSON blobs must be equal, wall time aside — with the superstep trace and
checkpoints on too; and the port's launcher resumes the JAX launcher's
checkpoints.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mine as tmine  # noqa: E402
from repro_torch.launch import mine_serve as tmine_serve  # noqa: E402

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
    for case in CASES + [TRACED]:
        path = out / f"{case[0]}_{case[1]}.json"
        extra = (["--ckpt-dir", str(out / "ckpt")] + TRACED_FLAGS
                 if case == TRACED else [])
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro.launch.mine", *_args(*case), *extra,
             "--json-out", str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        runs[case] = (proc, path)
    runs["ckpt_dir"] = out / "ckpt"
    yield runs
    for case in CASES + [TRACED]:
        proc = runs[case][0]
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


CASES = [(p, d) for p in ("three_phase", "fused23") for d in (1, 4)]
#: the case run with the superstep trace and segmented checkpoints on
TRACED = ("fused23", 3)
TRACED_FLAGS = ["--trace-period", "1", "--ckpt-period", "4"]


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


def test_traced_checkpointed_blob_matches_jax_and_resumes_its_ckpt(
        jax_launches, tmp_path, capsys):
    """--trace-period and --ckpt-dir/--ckpt-period: the JAX launcher's blob,
    superstep_trace and ckpt keys included; then --resume of the JAX
    launcher's checkpoints restores every phase to the same answer."""
    port_out, ck = tmp_path / "port.json", tmp_path / "ckpt"
    tmine.main(_args(*TRACED) + ["--device", "cpu", "--ckpt-dir", str(ck),
                                 *TRACED_FLAGS, "--json-out", str(port_out)])
    proc, jax_out = jax_launches[TRACED]
    _, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-4000:]
    want, got = _blob(jax_out), _blob(port_out)
    assert got == want   # a complete query reports no checkpoint path
    assert got["superstep_trace"]["sampled_steps"] == got["supersteps"][1]
    assert got["ckpt"]["writes"] > 0 and got["ckpt"]["resumed"] == []
    resumed_out = tmp_path / "resumed.json"
    tmine.main(_args(*TRACED) + ["--device", "cpu", "--resume",
                                 str(jax_launches["ckpt_dir"]), *TRACED_FLAGS,
                                 "--json-out", str(resumed_out)])
    again = _blob(resumed_out)
    assert again["ckpt"]["resumed"] == ["lamp1", "count2d"]
    assert "[ckpt] resumed phase(s)" in capsys.readouterr().err
    for k in ("lambda", "min_sup", "closed_sets", "significant", "patterns",
              "supersteps", "superstep_trace"):
        assert again[k] == got[k], k


@pytest.mark.parametrize("flags, match", [
    (["--hosts", "2", "--devices-per-host", "2", "--devices", "3"], "contradicts"),
    (["--hosts", "2"], "go together"),
    (["--devices-per-host", "2"], "go together"),
    (["--ckpt-dir", "ck"], "need --ckpt-period"),
    (["--resume", "ck"], "need --ckpt-period"),
])
def test_unported_flags_exit_naming_their_item(flags, match, capsys):
    """No flag is left unported: the topology flags exit as the JAX
    launcher's do when they are half given or contradict --devices, and
    the checkpoint flags without --ckpt-period."""
    with pytest.raises(SystemExit) as exc:
        tmine.main(PROBLEM + ["--device", "cpu"] + flags)
    assert exc.value.code == 2
    assert match in capsys.readouterr().err


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


def test_profile_out_puts_the_spans_beside_the_operators(tmp_path, capsys):
    path = tmp_path / "profile.json"
    tmine.main(PROBLEM + ["--device", "cpu", "--devices", "2", "--query",
                          "closed-frequent", "--min-sup", "20",
                          "--profile-out", str(path)])
    assert f"wrote the profile with the session's spans to {path}" in (
        capsys.readouterr().out)
    events = json.load(open(path))["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in spans}
    assert {"query:ClosedFrequentQuery", "pack", "roots", "dispatch", "carry",
            "superstep", "expand", "census.read", "outputs", "reconstruct",
            "closure.readback", "closure.scan"} <= names
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    (dispatch,) = [e for e in spans if e["name"] == "dispatch"]
    assert any(dispatch["ts"] <= o["ts"] <= dispatch["ts"] + dispatch["dur"]
               for o in ops)


#: the serving launcher's CI-sized run, at 4 miners per session
SERVE_ARGS = ["--smoke", "--devices", "4", "--verbose"]
#: the values of each --verbose query record both launchers must agree on
QUERY_KEYS = ("q", "cold", "outcome", "alpha", "min_sup", "k", "significant")
#: the summary counts both launchers must agree on
SUMMARY_KEYS = ("queries", "ok", "partial", "failed", "warm_violations",
                "warmup_compiles")


def _serve_records(stderr: str, event: str) -> list[dict]:
    return [r for r in (json.loads(line) for line in stderr.splitlines()
                        if line.startswith("{")) if r["event"] == event]


def test_serve_launcher_matches_jax(tmp_path, capsys):
    """`mine_serve --smoke --devices 4` of both packages serve the same
    queries with the same answers and the same warmup and cache counts."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.mine_serve", *SERVE_ARGS,
         "--json-out", str(jax_out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        rc = tmine_serve.main(SERVE_ARGS + ["--device", "cpu", "--json-out",
                                            str(port_out)])
    finally:
        _, jax_err = proc.communicate(timeout=600)
    assert proc.returncode == 0, jax_err[-4000:]
    assert rc == 0
    port_err = capsys.readouterr().err
    want = [{k: r[k] for k in QUERY_KEYS}
            for r in _serve_records(jax_err, "query")]
    got = [{k: r[k] for k in QUERY_KEYS}
           for r in _serve_records(port_err, "query")]
    assert len(want) == 4 and sorted(got, key=lambda r: r["q"]) == sorted(
        want, key=lambda r: r["q"])
    jblob, tblob = (json.load(open(p)) for p in (jax_out, port_out))
    assert {k: tblob[k] for k in SUMMARY_KEYS} == {k: jblob[k] for k in SUMMARY_KEYS}
    assert tblob["devices_per_session"] == jblob["devices_per_session"] == 4
    for k in ("programs", "misses"):
        assert tblob["cache"][k] == jblob["cache"][k], k
    assert tblob["failed"] == 0 and tblob["warm_violations"] == 0


def test_serve_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tmine_serve.main(["--smoke"])
