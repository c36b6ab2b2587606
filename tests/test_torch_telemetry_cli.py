"""The port's telemetry reader (``python -m sphexa_torch.telemetry``)
against the JAX package's ``sphexa-telemetry`` (sphexa_tpu/telemetry/cli.py),
on the CPU.

The run dirs: the port CLI's own run (Sedov 8, deferred windows, a
snapshot ring, a torch.profiler capture, ``--tuned`` through a table) and
a synthetic one made from a numpy seed that carries every event kind the
views read (per-rank loads and exchanges, both stages; memory; physics,
numerics, block-dt and watchdog events; tuning and sweep events; an
unknown kind, a schema-invalid event, an unparseable line; a
blackbox). The fixture files: two bench JSONs (a bench line and a round
wrapper) and a lock file. Every view's ``--format json`` output and exit
code equal the JAX CLI's on the same inputs, the paths left out; the
``trace`` view reads the port's capture; ``serve --once`` and ``fleet``
render; ``history`` without inputs exits 2.
"""

import json
import os

import numpy as np
import pytest
import torch

from sphexa_tpu.telemetry import cli as jcli

from sphexa_torch.app import main as app
from sphexa_torch.telemetry import cli as tcli
from sphexa_torch.tuning import table as ttable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _synthetic_run(path: str, seed: int) -> None:
    """A run dir whose events.jsonl holds every kind the views read, its
    numbers drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    os.makedirs(path)
    P = 4
    ev = []

    def add(kind, **kw):
        ev.append({"v": 8, "seq": len(ev), "t": 1.0e9 + len(ev), "kind": kind, **kw})

    add("tuning", source="table", workload="sedov", knobs={"gap": 128})
    add("reconfigure", it=0, reason="initial")
    add("memory", point="manifest", devices=["cpu"], bytes_in_use=[int(rng.integers(1e6))],
        peak_bytes_in_use=[int(rng.integers(1e6, 2e6))])
    it = 0
    for w in range(6):
        steps = int(rng.integers(1, 5))
        it += steps
        wall = float(rng.uniform(0.01, 0.1))
        add("window", it=it, steps=steps, wall_s=wall, per_step_s=wall / steps)
        add("step", it=it, wall_s=float(rng.uniform(0.01, 0.1)))
        add("phases", it=it, step=float(rng.uniform()), output=float(rng.uniform()))
        add("shard_load", it=it, particles=[int(x) for x in rng.integers(900, 1100, P)],
            work=[float(x) for x in rng.uniform(1, 2, P)])
        add("exchange", it=it, shipped_rows=int(rng.integers(1e4)), mode="sparse",
            rows=[int(x) for x in rng.integers(100, 200, P)],
            occ=[float(x) for x in rng.uniform(0, 1, P)],
            bytes_per_step=int(rng.integers(1e6)), trips=int(rng.integers(3)))
        add("exchange", it=it, stage="gravity", shipped_rows=int(rng.integers(1e4)),
            mode="sparse", rows=[int(x) for x in rng.integers(50, 90, P)],
            occ=[float(x) for x in rng.uniform(0, 1, P)], bytes_per_step=1000, trips=0)
        its = list(range(it - steps + 1, it + 1))
        etot = [float(1.0 + 1e-4 * x) for x in rng.standard_normal(steps)]
        add("physics", it=it, its=its, t_sim=[0.01 * i for i in its], dt=[0.01] * steps,
            etot=etot, ecin=etot, eint=etot, egrav=[0.0] * steps, linmom=etot, angmom=etot)
        add("numerics", it=it, limiter={"courant": steps, "rho": 1},
            nonfinite={"rho": 0, "h": int(w == 3)}, rho_min=float(rng.uniform()),
            rho_max=float(rng.uniform(1, 2)), h_min=0.01, h_max=0.05, du_max=1.0,
            nc_clip=0, h_sat=0)
        add("dt_bins", it=it, pop=[int(x) for x in rng.integers(0, 100, 3)],
            updates=int(rng.integers(100, 200)), updates_full=300, resorts=1, keeps=2)
    add("imbalance", it=it, metric="work", ratio=1.7, threshold=1.5)
    add("drift", it=it, drift=2e-3, budget=1e-3)
    add("field_health", it=it, nonfinite={"h": 1})
    add("rollback", it=it, to_it=it - 2, steps=2, reason="overflow")
    add("replay", it=it, steps=2)
    add("retrace", it=it, delta=2)
    add("reconfigure", it=it, reason="overflow")
    for c in range(3):
        add("sweep", candidate=c, knobs={"gap": [384, 128, 512][c]},
            status=["ok", "overflow", "ok"][c], objective="per_step_s",
            value=float(rng.uniform(0.01, 0.02)))
    add("future_kind", it=it)
    add("window", it=it)  # schema-invalid: steps, wall_s, per_step_s missing
    with open(os.path.join(path, "events.jsonl"), "w") as f:
        for e in ev:
            f.write(json.dumps(e) + "\n")
        f.write('{"v": 8, "kind": "step", "it"\n')  # a truncated line
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"schema": 1, "events_schema": 8, "git_rev": "abc", "backend": "cuda",
                   "device_count": 1, "mesh_shape": [P], "particles": 4000,
                   "config": {"init": "sedov", "side": 16}, "case": "sedov",
                   "tuning": {"source": "table", "key": {"workload": "sedov"},
                              "knobs": {"gap": 128}, "explicit": ["check_every"],
                              "entry_provenance": {"win": 0.1}}}, f)
    with open(os.path.join(path, "blackbox.json"), "w") as f:
        json.dump({"schema": 1, "reason": "SIGTERM", "traceback": "a\nb\nc\nd",
                   "events": ev[-5:], "watchdogs": {"rollbacks": 1, "events_total": 9}}, f)


def _bench(path: str, value: float, wrapped: bool) -> None:
    line = {"metric": "updates_per_sec", "value": value, "unit": "1/s",
            "vs_baseline": 1.0, "extra": {"ve_updates_per_sec": value / 2,
                                          "std_energy_drift": 1e-5, "step_ms": 6.0}}
    with open(path, "w") as f:
        json.dump({"rc": 0, "tail": "noise\n" + json.dumps(line) + "\n"} if wrapped else line,
                  f)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tel"))
    table = os.path.join(root, "table.json")
    t = ttable.new_table()
    ttable.upsert_entry(t, ttable.make_entry("sedov", 512, 1, "pallas", {"gap": 128},
                                             {"created": "2026-01-01", "device": "cpu"}))
    ttable.save_table(table, t)
    tel, trace = os.path.join(root, "port", "tel"), os.path.join(root, "port", "trace")
    rc = app.main(["--init", "sedov", "-n", "8", "-s", "4", "--check-every", "2", "--snap",
                   "rho", "--snap-every", "2", "--device", "cpu", "--tuned", table, "-o",
                   os.path.join(root, "port"), "--telemetry-dir", tel, "--trace-dir", trace,
                   "--quiet"])
    assert rc == 0
    synth = os.path.join(root, "synth")
    _synthetic_run(synth, 19)
    a, b = os.path.join(root, "bench_a.json"), os.path.join(root, "bench_b.json")
    _bench(a, 1.0e8, wrapped=True)
    _bench(b, 0.8e8, wrapped=False)
    lock = os.path.join(root, "lock.json")
    with open(lock, "w") as f:
        json.dump({"schema": 1, "metrics": [
            {"name": "std", "source": "bench_a.json", "field": "value", "value": 1.05e8,
             "threshold": 0.1},
            {"name": "drift", "source": "bench_a.json", "field": "extra.std_energy_drift",
             "value": 1e-5, "threshold": 0.1, "higher_is_better": False}]}, f)
    return {"root": root, "port": tel, "trace": trace, "synth": synth, "table": table,
            "a": a, "b": b, "lock": lock}


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, out


#: view -> argv (run-dir names are resolved from the fixture)
VIEWS = {
    "summary_port": ["summary", "{port}", "--strict"],
    "summary_synth": ["summary", "{synth}", "--strict"],
    "shards_port": ["shards", "{port}"],
    "shards_synth": ["shards", "{synth}"],
    "science_port": ["science", "{port}"],
    "science_synth": ["science", "{synth}", "--budget", "1e-5"],
    "tuning_port": ["tuning", "{port}"],
    "tuning_synth": ["tuning", "{synth}"],
    "tuning_table": ["tuning", "{table}", "--require", "sedov,512,1,pallas"],
    "tuning_table_gap": ["tuning", "{table}", "--require", "noh,1e6,1,pallas"],
    "diff_runs": ["diff", "{synth}", "{port}", "--threshold", "0.05"],
    "diff_drift": ["diff", "{port}", "{synth}", "--drift"],
    "diff_bench": ["diff", "{a}", "{b}"],
    "diff_mixed": ["diff", "{a}", "{port}"],
    "history": ["history", "{a}", "{b}", "{port}", "{synth}"],
    "regress": ["regress", "--lock", "{lock}"],
    "regress_candidate": ["regress", "--lock", "{lock}", "{b}"],
}


#: each view's exit code on these inputs: 1 where the view finds what it
#: gates on (no per-rank telemetry, a watchdog or the budget, a regression,
#: a coverage gap, schema problems under --strict)
RC = {"summary_port": 0, "summary_synth": 1, "shards_port": 1, "shards_synth": 0,
      "science_port": 0, "science_synth": 1, "tuning_port": 0, "tuning_synth": 0,
      "tuning_table": 0, "tuning_table_gap": 1, "diff_runs": 1, "diff_drift": 1,
      "diff_bench": 1, "diff_mixed": 1, "history": 0, "regress": 0, "regress_candidate": 1}


def _normalized(text: str, root: str):
    return json.loads(text.replace(root, "<root>")) if text.strip() else None


@pytest.mark.parametrize("view", list(VIEWS))
def test_json_matches_jax(view, inputs, capsys):
    argv = [a.format(**inputs) for a in VIEWS[view]] + ["--format", "json"]
    t_rc, t_out = _run(tcli.main, argv, capsys)
    j_rc, j_out = _run(jcli.main, argv, capsys)
    assert t_rc == j_rc and t_rc in (0, 1), (t_rc, j_rc)
    assert _normalized(t_out, inputs["root"]) == _normalized(j_out, inputs["root"]) is not None
    assert t_rc == RC[view], view
    if view == "summary_port":
        assert t_rc == 0 and json.loads(t_out)["windows"] == 2
    if view == "tuning_port":
        stamp = json.loads(t_out)["manifest_tuning"]
        assert t_rc == 0 and stamp["source"] == "table" and stamp["knobs"] == {"gap": 128}


def test_trace_reads_the_port_capture(inputs, capsys):
    rc, out = _run(tcli.main, ["trace", inputs["trace"], "--min-coverage", "0.8", "--format",
                               "json"], capsys)
    s = json.loads(out)
    assert rc == 0 and s["coverage"] >= 0.8 and s["device"] == "cpu"
    assert {"density", "iad", "momentum-energy"} <= {p["phase"] for p in s["phases"]}
    rc, out = _run(tcli.main, ["trace", inputs["trace"]], capsys)
    assert rc == 0 and "attributed:" in out and "density" in out
    rc, _ = _run(tcli.main, ["trace", inputs["trace"], "--min-coverage", "1.01"], capsys)
    assert rc == 1
    assert _run(tcli.main, ["trace", inputs["root"] + "/none"], capsys)[0] == 2


def test_text_views_render(inputs, capsys):
    for argv in (["summary", inputs["port"]], ["summary", inputs["synth"]],
                 ["shards", inputs["synth"]], ["science", inputs["synth"]],
                 ["tuning", inputs["port"]], ["diff", inputs["a"], inputs["b"]],
                 ["history", inputs["a"], inputs["port"]], ["regress", "--lock",
                                                            inputs["lock"]]):
        t_rc, t_out = _run(tcli.main, argv, capsys)
        j_rc, _ = _run(jcli.main, argv, capsys)
        assert t_rc == j_rc and t_out.strip(), argv
    rc, out = _run(tcli.main, ["summary", inputs["synth"]], capsys)
    assert "CRASH: SIGTERM" in out and "unknown kind: future_kind" in out


def test_serve_once_and_fleet(inputs, capsys):
    html = os.path.join(inputs["root"], "dash.html")
    rc, _ = _run(tcli.main, ["serve", inputs["root"] + "/*/tel", "--once", "--out", html],
                 capsys)
    assert rc == 0
    with open(html) as f:
        page = f.read()
    assert "data:image/png;base64" in page and "tuning: table" in page
    rc, out = _run(tcli.main, ["fleet", inputs["root"]], capsys)
    assert rc == 0 and "CRASHED" in out and "synth" in out
    rc, out = _run(tcli.main, ["fleet", inputs["root"] + "/*", "--format", "json"], capsys)
    j_rc, j_out = _run(jcli.main, ["fleet", inputs["root"] + "/*", "--format", "json"],
                       capsys)
    assert rc == j_rc == 0 and json.loads(out) == json.loads(j_out)
    assert _run(tcli.main, ["fleet", inputs["root"] + "/nothing*"], capsys)[0] == 1


def test_history_needs_inputs_and_stale_tables_fail(inputs, capsys, tmp_path):
    assert _run(tcli.main, ["history"], capsys)[0] == 2
    stale = ttable.load_table(inputs["table"])
    stale["entries"][0]["knobs"]["blocks_per_chunk"] = 8
    path = str(tmp_path / "stale.json")
    ttable.save_table(path, stale)
    rc, out = _run(tcli.main, ["tuning", path, "--format", "json"], capsys)
    assert rc == 1 and any("blocks_per_chunk" in p for p in json.loads(out)["problems"])
    assert _run(tcli.main, ["tuning", str(tmp_path / "none.json")], capsys)[0] == 2
