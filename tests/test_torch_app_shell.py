"""The rest of the port's app shell against the JAX package's, on the CPU:

- the in-situ renderer (sphexa_torch/viz.py): ``render_grid``,
  ``render_field`` and ``_png_bytes`` byte for byte the JAX package's on
  the same inputs;
- the lap timer and the profile series (telemetry/registry.py
  ``LapTimer`` / ``StepSeries``, util/timer.py), the cases of
  tests/test_timer.py;
- ``substep_breakdown``'s stages: std against the JAX function's keys
  (``backend="pallas"``, interpret mode) at Sedov 6, VE against
  tests/test_app_tail.py's list; {} on other propagators;
- ``gravitational_wave_signal`` against the JAX function in float64,
  rtol 1e-6;
- ``Simulation(debug_checks=True)``: "" on a clean step, a message with
  "nan" (naming the phase) after a NaN seeded in temp, ValueError with
  ``num_devices=2``, each beside the JAX package's own verdict;
- the CLI with ``--snap rho --insitu projection --profile --trace-dir``
  and ``--telemetry-dir``: its run dir passes the JAX package's
  ``summary --strict``, the JAX package's ``serve`` renders its frames,
  the trace's phase attribution covers the step, and profile.npz holds
  the JAX CLI's keys on the same run (the substeps aside: the JAX CLI's
  CPU default is its XLA path, which has none).
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu import viz as jax_viz
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.observables.extras import gravitational_wave_signal as jax_gw
from sphexa_tpu.simulation import Simulation as JaxSimulation
from sphexa_tpu.util.substep_profile import substep_breakdown as jax_substeps

from sphexa_torch import viz
from sphexa_torch.init import init_evrard, init_sedov
from sphexa_torch.observables.extras import GW_UNITS, gravitational_wave_signal
from sphexa_torch.simulation import Simulation
from sphexa_torch.telemetry import MemorySink, Telemetry
from sphexa_torch.telemetry.registry import LapTimer, StepSeries
from sphexa_torch.util import phases
from sphexa_torch.util.substep_profile import substep_breakdown
from sphexa_torch.util.timer import ProfileRecorder, Timer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the renderer ------------------------------------------------------------


@pytest.mark.parametrize("shape,log_scale,upsample", [((16, 16), True, 16), ((9, 9), False, 3),
                                                       ((2, 7, 7), True, 1)])
def test_render_grid_and_png_bytes_match_jax(shape, log_scale, upsample):
    grid = np.random.default_rng(11).gamma(2.0, 3.0, shape)
    g = grid[0] if grid.ndim == 3 else grid
    a = viz.render_grid(g, log_scale=log_scale, upsample=upsample)
    b = jax_viz.render_grid(g, log_scale=log_scale, upsample=upsample)
    np.testing.assert_array_equal(a, b)
    assert viz._png_bytes(a) == jax_viz._png_bytes(b)
    # the ring consumer: the same file bytes, a multi-field grid's first field
    out = {}
    for mod, key in ((viz, "torch"), (jax_viz, "jax")):
        InsituViz = mod.InsituViz
        v = InsituViz("unused", mode="projection", every=2, resolution=64,
                      writer=lambda path, data, key=key: out.setdefault(key, (path, data)))
        assert v.execute_grid(grid, 3) is None  # not due
        v.execute_grid(grid, 4)
        assert v.finalize() == 1
    assert out["torch"] == out["jax"]


def test_render_field_matches_jax():
    rng = np.random.default_rng(3)
    x, y, w = rng.uniform(-0.5, 0.5, 2000), rng.uniform(-0.5, 0.5, 2000), rng.uniform(0, 1, 2000)
    a = viz.render_field(x, y, w, (-0.5, 0.5, -0.5, 0.5), resolution=48)
    b = jax_viz.render_field(x, y, w, (-0.5, 0.5, -0.5, 0.5), resolution=48)
    assert viz._png_bytes(a) == jax_viz._png_bytes(b)


def test_insitu_mode_checked():
    with pytest.raises(ValueError):
        viz.InsituViz("unused", mode="volume")


# -- the lap timer and the profile series (tests/test_timer.py) --------------


class TestTimer:
    def test_step_accumulates_and_pop_clears(self):
        t = Timer()
        t.start()
        e1 = t.step("a")
        e2 = t.step("a")
        t.step("b")
        assert e1 >= 0.0 and e2 >= 0.0
        laps = t.pop()
        assert set(laps) == {"a", "b"}
        assert laps["a"] >= e1 + e2 - 1e-9
        assert t.pop() == {}

    def test_step_measures_elapsed(self):
        t = LapTimer()
        t.start()
        time.sleep(0.01)
        assert t.lap("sleep") >= 0.009

    def test_start_resets_mark(self):
        t = Timer()
        time.sleep(0.01)
        t.start()
        assert t.step("a") < 0.009

    def test_laps_mirror_into_telemetry(self):
        tel = Telemetry()
        t = Timer(telemetry=tel)
        t.start()
        t.step("phase")
        t.step("phase")
        assert tel.phase_counts["phase"] == 2
        assert tel.timing_mean("phase") >= 0.0


class TestProfileRecorder:
    def test_save_empty_writes_nothing(self, tmp_path):
        path = str(tmp_path / "profile.npz")
        assert ProfileRecorder().save(path) is False
        assert not os.path.exists(path)

    def test_save_substeps_only_still_writes(self, tmp_path):
        path = str(tmp_path / "profile.npz")
        assert ProfileRecorder().save(path, substeps={"density": 0.5}) is True
        assert float(np.load(path)["substep_density"]) == 0.5

    def test_ragged_rows_nan_padded(self, tmp_path):
        p = StepSeries()
        p.record(1, {"step": 0.5}, dt=0.1)
        p.record(2, {"step": 0.7, "output": 0.2}, dt=0.3)
        path = str(tmp_path / "profile.npz")
        assert p.save(path) is True
        data = np.load(path)
        np.testing.assert_array_equal(data["iteration"], [1.0, 2.0])
        np.testing.assert_allclose(data["step"], [0.5, 0.7])
        assert np.isnan(data["output"][0]) and data["output"][1] == 0.2

    def test_summary_nanmean_skips_missing(self):
        p = ProfileRecorder()
        p.record(1, {"step": 0.5})
        p.record(2, {"step": 0.7, "output": 0.2})
        s = p.summary()
        assert s["step"] == pytest.approx(0.6)
        assert s["output"] == pytest.approx(0.2)
        assert ProfileRecorder().summary() == {}

    def test_record_emits_phases_event(self):
        sink = MemorySink()
        tel = Telemetry(sinks=[sink])
        p = StepSeries(telemetry=tel)
        p.record(3, {"step": 0.25}, dt=0.5)
        (e,) = sink.of_kind("phases")
        assert e["it"] == 3 and e["step"] == 0.25 and e["dt"] == 0.5
        assert tel.phase_counts["step"] == 1


# -- the phase scopes ----------------------------------------------------------


def test_phase_scope_is_null_without_profiler_and_names_ranges_with_one():
    assert phases.phase_scope("density") is phases.phase_scope("sort")  # the null context
    with pytest.raises(AssertionError):
        phases.phase_scope("densty")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with phases.phase_scope("density"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "sphexa/density" in names


# -- the substep split ----------------------------------------------------------


def test_substep_keys_std_match_jax():
    js, jb, jc = jax_init_sedov(6)
    jsim = JaxSimulation(js, jb, jc, prop="std", backend="pallas")
    jkeys = sorted(jax_substeps(jsim, iters=1))
    st, box, const = init_sedov(6, device="cpu")
    sim = Simulation(st, box, const, device="cpu")
    sink = MemorySink()
    out = substep_breakdown(sim, iters=1, telemetry=Telemetry(sinks=[sink]))
    assert sorted(out) == jkeys
    assert all(v >= 0.0 for v in out.values())
    (e,) = sink.of_kind("phases")
    assert sorted(k for k in e if k.startswith("substep_")) == [f"substep_{k}" for k in jkeys]


def test_substep_keys_ve_and_none_elsewhere():
    st, box, const = init_sedov(6, device="cpu")
    sub = substep_breakdown(Simulation(st, box, const, prop="ve", device="cpu"), iters=1)
    for key in ("sort", "neighbor_prologue", "xmass", "ve_def_gradh", "eos", "iad",
                "divv_curlv", "av_switches", "momentum_energy"):
        assert key in sub and sub[key] >= 0.0
    st, box, const = init_evrard(6, device="cpu")
    assert substep_breakdown(Simulation(st, box, const, prop="nbody", device="cpu")) == {}


# -- the gravitational-wave signal ---------------------------------------------


def test_gravitational_wave_signal_matches_jax():
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal(400) for _ in range(9)] + [rng.uniform(0.5, 1.5, 400)]
    with jax.enable_x64(True):
        j = jax_gw(*[jnp.asarray(a) for a in arrs], 0.7, 1.3)
        jv = [float(j[0]), float(j[1])] + [float(j[2][k]) for k in sorted(j[2])]
    t = gravitational_wave_signal(*[torch.from_numpy(a) for a in arrs], 0.7, 1.3)
    tv = [float(t[0]), float(t[1])] + [float(t[2][k]) for k in sorted(t[2])]
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    assert abs(tv[0]) > 0.0 and GW_UNITS == pytest.approx(2.6770801e-72)


# -- the debug checks ---------------------------------------------------------------


def test_debug_checks_match_jax_verdicts():
    js, jb, jc = jax_init_sedov(6)
    jsim = JaxSimulation(js, jb, jc, prop="std", debug_checks=True)
    st, box, const = init_sedov(6, device="cpu")
    sim = Simulation(st, box, const, device="cpu", debug_checks=True, check_every=4)
    assert sim.check_every == 1 and sim.lists is None
    jd, d = jsim.step(), sim.step()
    assert jd["check_error"] == d["check_error"] == ""
    bad = np.asarray(jsim.state.temp).copy()
    bad[3] = np.nan
    jsim.state = dataclasses.replace(jsim.state, temp=jnp.asarray(bad))
    t = sim.state.temp.clone()
    t[3] = float("nan")
    sim.state = dataclasses.replace(sim.state, temp=t)
    jd, d = jsim.step(), sim.step()
    assert "nan" in jd["check_error"].lower()
    assert "nan" in d["check_error"].lower() and "phase 'sort'" in d["check_error"], d
    with pytest.raises(ValueError):
        JaxSimulation(js, jb, jc, prop="std", debug_checks=True, num_devices=2)
    with pytest.raises(ValueError):
        Simulation(st, box, const, device="cpu", debug_checks=True, num_devices=2)


def test_debug_checks_out_of_range_runs():
    """A run past the j-arrays' end is reported before the kernel reads
    it, named by the phase of the op that would launch."""
    from sphexa_torch.sph import pair_engine as pe

    st, box, const = init_sedov(6, device="cpu")
    sim = Simulation(st, box, const, device="cpu", use_lists=False)
    s, cfg = sim.state, sim.cfg
    from sphexa_torch.sfc.keys import compute_sfc_keys

    keys = compute_sfc_keys(s.x, s.y, s.z, sim.box, curve=cfg.curve)
    order = torch.argsort(keys, stable=True)
    x, y, z, h, m = (getattr(s, f)[order] for f in ("x", "y", "z", "h", "m"))
    ranges = pe.group_cell_ranges(x, y, z, h, keys[order], sim.box, cfg.nbr)
    bad = ranges._replace(starts=ranges.starts + s.n)
    with phases.debug_checks() as dbg:
        pe.pallas_density(x, y, z, h, m, keys[order], sim.box, const, cfg.nbr, ranges=ranges)
        assert dbg.error == ""
        with pytest.raises(Exception):
            pe.pallas_density(x, y, z, h, m, keys[order], sim.box, const, cfg.nbr,
                              ranges=bad)
    assert dbg.error.startswith("out-of-bounds index in phase 'density'"), dbg.error


# -- the CLI ---------------------------------------------------------------------------


def test_cli_app_shell_run_dir_against_jax(tmp_path, capsys):
    from sphexa_tpu.app.main import main as jax_main
    from sphexa_tpu.telemetry.cli import main as telemetry_main
    from sphexa_tpu.telemetry.serve import serve_cmd

    from sphexa_torch.app.main import main

    out, tel, trace = tmp_path / "out", tmp_path / "tel", tmp_path / "trace"
    argv = ["--init", "sedov", "-n", "8", "-s", "4", "--check-every", "2", "--profile"]
    rc = main(argv + ["--snap", "rho", "--insitu", "projection", "--snap-every", "2",
                      "--trace-dir", str(trace), "--telemetry-dir", str(tel), "-o", str(out),
                      "--device", "cpu"])
    assert rc == 0
    log = capsys.readouterr().out
    assert "# phase attribution: " in log and "# substeps" in log
    assert sorted(os.listdir(out)) == ["constants.txt", "insitu_projection_000002.png",
                                       "insitu_projection_000004.png", "profile.npz"]
    assert sorted(os.listdir(tel / "snapshots")) == ["snap_000002.npz", "snap_000004.npz"]
    events = [json.loads(line) for line in open(tel / "events.jsonl")]
    kinds = [e["kind"] for e in events]
    assert kinds.count("snapshot") == 2 and kinds.count("trace") == 1
    (attr,) = [e for e in events if e["kind"] == "phase_attr"]
    assert attr["coverage"] >= 0.8 and "density" in attr["phases"]
    assert [e["it"] for e in events if e["kind"] == "phases" and "step" in e] == [2, 4]
    assert telemetry_main(["summary", "--strict", str(tel)]) == 0
    assert serve_cmd(str(tel), out=str(tmp_path / "dash.html"), once=True) == 0
    assert "data:image/png;base64," in open(tmp_path / "dash.html").read()
    # profile.npz: the JAX CLI's keys on the same run
    jout = tmp_path / "jax"
    assert jax_main(argv + ["-o", str(jout), "--quiet"]) == 0
    ours = np.load(out / "profile.npz")
    theirs = np.load(jout / "profile.npz")
    assert sorted(k for k in ours.files if not k.startswith("substep_")) == \
        sorted(k for k in theirs.files if not k.startswith("substep_"))
    assert {"substep_density", "substep_momentum_energy"} <= set(ours.files)
    np.testing.assert_array_equal(ours["iteration"], theirs["iteration"])


def test_cli_usage_errors(tmp_path, capsys):
    from sphexa_torch.app.main import main

    base = ["--init", "sedov", "-n", "6", "-s", "1", "-o", str(tmp_path), "--device", "cpu"]
    assert main(base + ["--snap", "rho,pressure", "--telemetry-dir", str(tmp_path / "t")]) == 2
    assert "unknown snapshot field 'pressure'" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "t" / "blackbox.json")
    assert main(base + ["--insitu", "volume"]) == 2
    assert main(base + ["--debug-checks", "--devices", "2"]) == 2
    assert "single-device" in capsys.readouterr().err
    assert main(base + ["--memory-profile", str(tmp_path / "m.pickle"), "--quiet"]) == 0
    assert "--memory-profile: profiler unavailable" in capsys.readouterr().err
