"""The port's deferred check windows, driver telemetry and science rows on
the CPU: its copy of tests/test_simulation_async.py and of the driver
parts of tests/test_telemetry.py, and the list-mode deferred run against
the JAX package's.

Tolerances: a deferred streaming run equals the synchronous one bit for
bit (the same kernels on the same inputs); after a rollback and replay
the state is within rel 1e-6 (positions) and 1e-5 (temperature) of a
clean run, as the JAX tests hold theirs; the list-mode run against the
JAX ``Simulation(check_every=3)`` per-particle fields order-insensitive at
tests/test_torch_list_slice.py's list-mode tolerances (x rtol 2e-6, temp
and vx 1e-4, atol 1e-7)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_noh as jax_init_noh
from sphexa_tpu.simulation import Simulation as JaxSimulation
from sphexa_tpu.telemetry import MemorySink as JaxMemorySink
from sphexa_tpu.telemetry import Telemetry as JaxTelemetry

from sphexa_torch.app import main as app
from sphexa_torch.init import init_noh, init_sedov
from sphexa_torch.kernels import deferred_checks
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.propagator import STEP_DIAG_KEYS
from sphexa_torch.simulation import Simulation
from sphexa_torch.telemetry import ConsoleSink, JsonlSink, MemorySink, Telemetry, validate_event

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sedov(side=10, **kw):
    return Simulation(*init_sedov(side, device="cpu"), device="cpu", **kw)


def _final_state(sim, steps):
    for _ in range(steps):
        sim.step()
    sim.flush()
    return sim.state


# -- deferred windows (tests/test_simulation_async.py) -----------------------


def test_async_matches_sync():
    """Streaming (Sedov 12: a fold-mode grid), check_every 4 against 1
    over 6 steps: every field and science row bit for bit."""
    r = deferred_checks.matches_sync(12, "cpu", window=4, steps=6)
    assert r["bitwise"] and r["energy_drift"] < 1e-6


def test_deferred_overflow_rolls_back_and_replays():
    """The cap forced to 8 in a window of 5 (Sedov 12): the flush finds the
    overflow, rolls back, re-sizes and replays; the state is a clean run's
    within rel 1e-6 (``deferred_checks.cap_rollback`` holds each step)."""
    r = deferred_checks.cap_rollback(12, "cpu", window=5)
    assert r["replays"] == 5 and r["reconfigures"] == 1


def test_flush_idempotent_and_deferred_flag():
    sim = _sedov(10, check_every=8)
    d1 = sim.step()
    assert d1.get("deferred") == 1.0
    d2 = sim.flush()
    assert d2.get("deferred") != 1.0
    assert sim.flush() is d2  # nothing pending
    assert set(STEP_DIAG_KEYS) <= set(d2)


def test_deferred_h_outgrows_cell_mid_window():
    """h outgrows the configured search window after configuration and
    before the window: the deferred steps run unchecked on a window too
    small (the in-step window guard reports the cap + 1 sentinel), and
    the flush rolls the window back and replays it through the checked
    path, which re-sizes first; the result is a clean run's from the
    grown state. Sedov 24 with cell_target 8, configured at h / 4 (level
    4, window 10 of 16 cells) and then h x 4 (back to the initial h, which
    needs level 3): the JAX test's h x 4 at side 32 with a window of 4
    would take minutes with the plain versions on the CPU, and smaller
    sides put the grid in fold mode, which covers any h. A window of 2
    keeps the case under 20 s. (The card runs the JAX test's form,
    chip_smoke.py's deferred_checks.)"""
    r = deferred_checks.h_growth_rollback(24, "cpu", window=2, cell_target=8, shrink=0.25)
    assert r["nbr_before"]["level"] == 4 and r["nbr_after"]["level"] == 3
    assert r["rollback"] == "overflow"


def test_ve_list_window_replays_on_expiry():
    """VE list mode (Noh 14): a window on lists that no longer cover a
    displaced particle rolls back on ``list-expiry``, rebuilds without a
    re-size and replays; the result agrees with a synchronous run."""
    r = deferred_checks.list_expiry_replay(14, "cpu", prop="ve", window=4, case="noh")
    assert r["rollbacks"][-1] == (8, "list-expiry")


def test_happy_window_reads_the_card_once(monkeypatch):
    """A happy window calls ``_fetch_scalars`` once, at its flush, for all
    of its steps (on the card the one host sync; the card's test counts
    the syncs themselves, tests/test_torch_gpu.py)."""
    sim = _sedov(12, check_every=4, obs_spec=ObservableSpec(extra="mach"),
                 science_rows=True, drift_budget=1e3)
    for _ in range(4):
        sim.step()  # settle the first window
    calls = []
    real = sim._fetch_scalars
    monkeypatch.setattr(sim, "_fetch_scalars", lambda entries: calls.append(len(entries))
                        or real(entries))
    for _ in range(3):
        assert sim.step().get("deferred") == 1.0
    assert calls == []
    d = sim.step()
    assert d.get("deferred") != 1.0 and calls == [4]
    rows = sim.drain_science()
    assert [r["it"] for r in rows] == list(range(1, 9))
    assert all(np.isfinite(r["etot"]) and "extra" in r for r in rows)


# -- list mode: list-expiry rollbacks, against the JAX package ---------------


def test_list_mode_deferred_matches_jax():
    """Noh 14, skin 0.05 x 2 h, check_every 3, 12 steps: windows roll back
    on expired lists (``list-expiry``: a rebuild, no re-size) and replay;
    the JAX package's Simulation(backend="pallas", use_lists=True,
    check_every=3) rebuilds at the same iterations and rolls back the same
    windows; the fields agree order-insensitively."""
    sink = MemorySink()
    sim = Simulation(*init_noh(14, device="cpu"), device="cpu", check_every=3,
                     list_skin_rel=0.05, obs_spec=ObservableSpec(),
                     telemetry=Telemetry(sinks=[sink]))
    jsink = JaxMemorySink()
    js, jb, jc = jax_init_noh(14)
    jsim = JaxSimulation(js, jb, jc, prop="std", backend="pallas", use_lists=True,
                         check_every=3, list_skin_rel=0.05,
                         telemetry=JaxTelemetry(sinks=[jsink]))
    for _ in range(12):
        sim.step()
        jsim.step()
    sim.flush()
    jsim.flush()
    assert sim.iteration == jsim.iteration == 12
    rollbacks = [(e["it"], e["reason"]) for e in sink.of_kind("rollback")]
    assert rollbacks and all(reason == "list-expiry" for _, reason in rollbacks)
    assert rollbacks == [(e["it"], e["reason"]) for e in jsink.of_kind("rollback")]
    rebuilds = [e["it"] for e in sink.of_kind("rebuild_lists")]
    assert rebuilds == [e["it"] for e in jsink.of_kind("rebuild_lists")]
    assert sim.rebuilds >= 2 and sim.reconfigures == 0
    assert len(sink.of_kind("replay")) == len(rollbacks) == sim.rollbacks
    s0, s1 = jsim.state, sim.state
    assert float(s1.ttot) == pytest.approx(float(s0.ttot), rel=1e-6)
    for f, tol in (("x", 2e-6), ("temp", 1e-4), ("vx", 1e-4)):
        np.testing.assert_allclose(np.sort(getattr(s1, f).numpy()),
                                   np.sort(np.asarray(getattr(s0, f))),
                                   rtol=tol, atol=1e-7, err_msg=f)


# -- driver telemetry (tests/test_telemetry.py) ------------------------------


def test_sync_steps_emit_step_events():
    sink = MemorySink()
    sim = _sedov(8, telemetry=Telemetry(sinks=[sink]))
    sim.step()
    sim.step()
    steps = sink.of_kind("step")
    assert [e["it"] for e in steps] == [1, 2]
    assert all(e["wall_s"] > 0 and e["dt"] > 0 for e in steps)
    (recfg,) = sink.of_kind("reconfigure")
    assert recfg["reason"] == "initial"
    assert all(validate_event(e) == [] for e in sink.events)


def test_rollback_replay_events_and_rows():
    """A deferred overflow surfaces as rollback and replay events; the
    rolled-back window writes no science row, its replay writes one per
    step."""
    sink = MemorySink()
    sim = _sedov(10, check_every=3, science_rows=True, obs_spec=ObservableSpec(),
                 telemetry=Telemetry(sinks=[sink]))
    sim._cfg = dataclasses.replace(sim._cfg, nbr=dataclasses.replace(sim._cfg.nbr, cap=8))
    for _ in range(3):
        d = sim.step()
    assert d["reconfigured"] == 1.0
    (rb,) = sink.of_kind("rollback")
    assert rb["reason"] == "overflow"
    assert rb["steps"] == 3 and rb["to_it"] == 0 and rb["bad_index"] == 0
    (rp,) = sink.of_kind("replay")
    assert rp["steps"] == 3
    assert len(sink.of_kind("step")) == 3  # the replay runs the checked path
    assert len(sink.of_kind("launch")) == 3
    assert any(e["reason"] == "overflow" for e in sink.of_kind("reconfigure"))
    assert sim.telemetry.counters["rollbacks"] == 1 == sim.rollbacks
    assert sim.replays == 3
    assert [r["it"] for r in sim.drain_science()] == [1, 2, 3]
    assert len(sink.of_kind("physics")) == 3


def test_run_line_and_printer_fallback():
    """run() reports through the console sink, else the printer, with nan
    for missing scalars, and ends in a flush."""
    lines = []
    sim = _sedov(8, telemetry=Telemetry(sinks=[ConsoleSink(printer=lines.append)]))
    sim.step = lambda: {"reconfigured": 0.0}
    sim.run(1, log_every=1, printer=None)
    (line,) = [ln for ln in lines if ln.startswith("it ")]
    assert "rho_max=nan" in line
    lines = []
    sim = _sedov(8, check_every=2)
    state = sim.run(3, log_every=1, printer=lines.append)
    assert state is sim.state and not sim._pending and sim.iteration == 3
    assert "(deferred check)" in lines[0] and "rho_max=" in lines[1]


def test_drift_watchdog_fires_on_energy_leak():
    sink = MemorySink()
    sim = _sedov(8, telemetry=Telemetry(sinks=[sink]), drift_budget=0.05,
                 obs_spec=ObservableSpec())
    sim.step()  # establishes etot0
    assert sink.of_kind("drift") == []
    sim.state = dataclasses.replace(sim.state, temp=sim.state.temp * 2.0)
    sim.step()
    events = sink.of_kind("drift")
    assert events and events[-1]["drift"] > 0.05 and events[-1]["budget"] == 0.05
    assert sim.telemetry.counters["drifts"] >= 1 and sim.energy_drift > 0.05
    assert all(validate_event(e) == [] for e in sink.events)


def test_drift_watchdog_fires_on_mid_window_excursion():
    def diag(it, etot):
        return {"obs_ttot": it * 1e-3, "dt": 1e-3, "obs_etot": etot, "obs_ecin": 0.0,
                "obs_eint": etot, "obs_egrav": 0.0, "obs_linmom": 0.0, "obs_angmom": 0.0}

    sink = MemorySink()
    sim = _sedov(8, telemetry=Telemetry(sinks=[sink]), drift_budget=0.1)
    sim._emit_science([diag(1, 1.0), diag(2, 1.5), diag(3, 1.0)], [1, 2, 3])
    (ev,) = sink.of_kind("drift")
    assert ev["it"] == 2 and ev["drift"] == pytest.approx(0.5)
    assert sim.energy_drift == pytest.approx(0.0)


def test_drift_watchdog_silent_without_budget():
    sink = MemorySink()
    sim = _sedov(8, telemetry=Telemetry(sinks=[sink]), obs_spec=ObservableSpec())
    sim.step()
    sim.state = dataclasses.replace(sim.state, temp=sim.state.temp * 2.0)
    sim.step()
    assert sink.of_kind("drift") == [] and sim.energy_drift > 0.05


def test_field_health_watchdog_fires_on_seeded_nan():
    sink = MemorySink()
    sim = _sedov(8, telemetry=Telemetry(sinks=[sink]), obs_spec=ObservableSpec())
    sim.step()
    assert sink.of_kind("field_health") == []
    vx = sim.state.vx.clone()
    vx[0] = float("nan")
    sim.state = dataclasses.replace(sim.state, vx=vx)
    d = sim.step()
    assert int(d["n_bad_du"]) > 0
    (ev,) = sink.of_kind("field_health")
    assert ev["nonfinite"] > 0 and ev["fields"]["du"] > 0
    assert "--debug-checks" in ev["hint"]
    assert sim.telemetry.counters["field_health"] == 1


def test_events_file_passes_the_jax_summary_strict(tmp_path):
    """A deferred run with a rollback writes events.jsonl that the JAX
    package's ``sphexa-telemetry summary --strict`` accepts, in a process
    of its own."""
    run = tmp_path / "run"
    tel = Telemetry(sinks=[JsonlSink(str(run / "events.jsonl"))])
    sim = _sedov(8, check_every=3, obs_spec=ObservableSpec(), telemetry=tel,
                 drift_budget=1e-12)
    sim._cfg = dataclasses.replace(sim._cfg, nbr=dataclasses.replace(sim._cfg.nbr, cap=8))
    sim.run(7)
    tel.event("run_end", iterations=sim.iteration, wall_s=1.0)
    tel.close()
    kinds = {json.loads(ln)["kind"] for ln in open(run / "events.jsonl")}
    assert {"rollback", "replay", "window", "physics", "numerics", "drift"} <= kinds
    out = subprocess.run(
        [sys.executable, "-m", "sphexa_tpu.telemetry", "summary", "--strict",
         "--format", "json", str(run)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr
    s = json.loads(out.stdout)
    assert s["schema_problems"] == [] and not s["unknown_kinds"]
    assert s["rollbacks"] == 1 and s["steps"] == 7


def test_cli_check_every_writes_a_row_per_step(tmp_path, capsys):
    """``--check-every 4 -s 6``: one constants.txt row per step (the last
    window flushed at the end), and the events file."""
    out_dir = tmp_path / "out"
    assert app.main(["--init", "sedov", "-n", "8", "-s", "6", "--check-every", "4",
                     "--device", "cpu", "-o", str(out_dir),
                     "--telemetry-dir", str(out_dir / "tel")]) == 0
    out = capsys.readouterr().out
    assert "(deferred check)" in out and "it     4  t=" in out
    lines = (out_dir / "constants.txt").read_text().splitlines()
    assert lines[0] == "# iteration time minDt etot ecin eint egrav"
    assert [int(float(ln.split()[0])) for ln in lines[1:]] == list(range(1, 7))
    events = [json.loads(ln) for ln in open(out_dir / "tel" / "events.jsonl")]
    assert [e["steps"] for e in events if e["kind"] == "window"] == [4, 2]
    assert events[-1]["kind"] == "run_end"
