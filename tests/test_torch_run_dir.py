"""The port's run directory (sphexa_torch/telemetry manifest.py,
flightrec.py, memory.py and the CLI's --telemetry-dir) against the JAX
package's readers: the manifest has the JAX manifest's keys less the
backend block, the flight recorder writes a blackbox on an injected
exception and disarms on close, the memory events carry the JAX keys,
and a CPU CLI run directory passes ``sphexa-telemetry summary --strict``
run in a process of its own."""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from sphexa_tpu.telemetry import flightrec as jax_flightrec
from sphexa_tpu.telemetry import manifest as jax_manifest
from sphexa_tpu.telemetry import memory as jax_memory

from sphexa_torch.app import main as app
from sphexa_torch.telemetry import (
    MANIFEST_SCHEMA, FlightRecorder, JsonlSink, MemorySink, Telemetry,
    build_manifest, device_memory_snapshot, emit_memory_event, read_blackbox, read_manifest,
    write_manifest,
)
from sphexa_torch.telemetry.manifest import backend_block

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BACKEND_KEYS = {"jax_version", "backend", "device_count"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _summary(run_dir):
    out = subprocess.run(
        [sys.executable, "-m", "sphexa_tpu.telemetry", "summary", "--strict", "--format",
         "json", str(run_dir)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout)


def test_manifest_keys_match_jax(tmp_path):
    kw = {"config": {"side": 4}, "particles": 64, "extra": {"case": "sedov"}}
    port = build_manifest(device="cpu", **kw)
    jax = jax_manifest.build_manifest(**kw)
    assert MANIFEST_SCHEMA == jax_manifest.MANIFEST_SCHEMA
    assert set(port) - set(backend_block("cpu")) == set(jax) - JAX_BACKEND_KEYS
    assert {k: port[k] for k in ("schema", "events_schema", "particles", "config", "case")} \
        == {k: jax[k] for k in ("schema", "events_schema", "particles", "config", "case")}
    assert port["backend"] == "cpu" and port["device_name"] is None
    written = write_manifest(str(tmp_path), device="cpu", **kw)
    assert read_manifest(str(tmp_path)) == json.loads(json.dumps(written))
    assert jax_manifest.read_manifest(str(tmp_path))["particles"] == 64
    assert read_manifest(str(tmp_path / "none")) is None


def test_memory_snapshot_keys_match_jax():
    snap = device_memory_snapshot(["cpu"])
    assert list(snap) == ["devices", *jax_memory._STAT_KEYS]
    assert all(snap[k] == [] for k in jax_memory._STAT_KEYS)
    assert emit_memory_event(Telemetry(), "flush") is None  # no sink: skipped
    sink = MemorySink()
    emit_memory_event(Telemetry(sinks=[sink]), "flush", devices=["cpu"], it=3)
    (e,) = sink.of_kind("memory")
    assert e["point"] == "flush" and e["it"] == 3 and e["bytes_in_use"] == []


def test_flight_recorder_dumps_on_an_injected_exception(tmp_path, capsys):
    run = str(tmp_path)
    tel = Telemetry(sinks=[JsonlSink(os.path.join(run, "events.jsonl"))])
    rec = FlightRecorder(run, capacity=4, telemetry=tel, manifest={"case": "sedov"})
    tel.sinks.append(rec.sink)
    hook, term = sys.excepthook, signal.getsignal(signal.SIGTERM)
    rec.install()
    try:
        assert sys.excepthook != hook
        for it in range(6):
            tel.event("step", it=it, wall_s=0.1)
        tel.count("rollbacks")
        try:
            raise RuntimeError("injected")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
    finally:
        rec.close()
        tel.close()
    assert sys.excepthook == hook and signal.getsignal(signal.SIGTERM) == term
    assert "injected" in capsys.readouterr().err  # the previous hook still ran
    box = read_blackbox(run)
    assert box == jax_flightrec.read_blackbox(run)
    assert box["reason"] == "exception RuntimeError: injected"
    assert [e["it"] for e in box["events"]] == [2, 3, 4, 5]
    assert box["watchdogs"]["rollbacks"] == 1 and box["manifest"] == {"case": "sedov"}
    assert not os.path.exists(os.path.join(run, "fault.log"))
    events = [json.loads(ln) for ln in open(os.path.join(run, "events.jsonl"))]
    assert events[-1]["kind"] == "crash" and events[-1]["seq"] == 6
    s = _summary(run)
    assert s["crash"]["reason"] == box["reason"]
    assert rec.dump("again") is None  # the first cause wins


def test_cli_run_dir_passes_the_jax_summary_strict(tmp_path):
    out = tmp_path / "out"
    tel = out / "tel"
    assert app.main(["--init", "sedov", "-n", "8", "-s", "6", "--check-every", "4",
                     "--device", "cpu", "-o", str(out), "--telemetry-dir", str(tel),
                     "--quiet"]) == 0
    manifest = json.loads((tel / "manifest.json").read_text())
    assert manifest["backend"] == "cpu" and manifest["particles"] == 512
    assert manifest["case"] == "sedov" and manifest["config"]["check_every"] == 4
    assert not (tel / "blackbox.json").exists() and not (tel / "fault.log").exists()
    events = [json.loads(ln) for ln in open(tel / "events.jsonl")]
    assert [e["point"] for e in events if e["kind"] == "memory"] == [
        "manifest", "post-compile", "flush", "flush"]
    assert events[-1]["kind"] == "run_end" and events[-1]["iterations"] == 6
    s = _summary(tel)
    assert s["schema_problems"] == [] and not s["unknown_kinds"] and s["crash"] is None
    assert s["manifest"]["particles"] == 512 and s["windows"] == 2 and s["steps"] == 6


def test_cli_construction_failure_leaves_a_blackbox(tmp_path, capsys):
    tel = tmp_path / "tel"
    hook = sys.excepthook
    # Ewald gravity needs a cubic periodic box: Gresho-Chan's slab is not
    assert app.main(["--init", "gresho-chan", "-n", "8", "--G", "1.0", "--device", "cpu",
                     "-o", str(tmp_path), "--telemetry-dir", str(tel), "--quiet"]) == 2
    assert "Ewald gravity requires a cubic periodic box" in capsys.readouterr().err
    assert sys.excepthook == hook
    box = read_blackbox(str(tel))
    assert box["reason"].startswith("simulation construction failed: Ewald gravity requires")
