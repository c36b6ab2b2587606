"""The port's field snapshots (sphexa_torch/observables/snapshot.py and
the Simulation's frame ring) against the JAX package's, on the CPU.

- ``snapshot_diagnostics`` of both packages on one seeded state (some
  rows outside the box, so the clipped boundary cells fill too): the
  projection on each axis, the volume, the "max" reduction and the
  strided subsample; sums within rtol 1e-6 of the grid's max (float32
  scatter-adds in another order), max grids, extrema of a "max" grid and
  ``snap_pts`` exact; ``SnapshotSpec``'s errors the same;
- a port ``Simulation`` and a JAX ``Simulation`` (Sedov 8, three steps):
  the frames' grids within rtol 1e-5 (two trajectories: the float32
  density sums in another order), their meta equal. The grid side is
  odd, 15: the lattice's half-integer positions then never sit on a cell
  boundary, where round-off between two runs could move a particle into
  the next cell;
- ``check_every=4`` frames equal the checked ones, with one
  ``_fetch_scalars`` read a window; a rolled-back window writes no frame
  twice and its replay writes them;
- two gloo ranks (the CLI's ``--devices 2``, one spawn) against one
  device: rank 0's frame of m and temp against the one-device deposit of
  the same particles (the ranks' ``--ascii`` dump), within tests/
  test_serve.py's rtol 1e-6 and atol 1e-12; rank 0 renders the frames
  and writes profile.npz (no substeps on a mesh), every rank its trace.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.observables.snapshot import SnapshotSpec as JaxSpec
from sphexa_tpu.observables.snapshot import snapshot_diagnostics as jax_snapshot
from sphexa_tpu.simulation import Simulation as JaxSimulation

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.init import init_sedov
from sphexa_torch.kernels.app_checks import grid_vs_dump
from sphexa_torch.observables.snapshot import SNAP_FIELDS, SnapshotSpec, snapshot_diagnostics
from sphexa_torch.simulation import Simulation
from sphexa_torch.telemetry import MemorySink, Telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _seeded_state(seed: int = 5, side: int = 8):
    """The JAX Sedov state with every snapshot field and the positions
    drawn from a seed (a few rows outside the box), and the port's twin."""
    js, jb, jc = jax_init_sedov(side)
    rng = np.random.default_rng(seed)
    n = js.x.shape[0]
    fields = {f.name: np.array(getattr(js, f.name)) for f in dataclasses.fields(js)}
    for f in ("x", "y", "z"):
        fields[f] = rng.uniform(-0.55, 0.55, n).astype(np.float32)
    for f in ("m", "temp", "vx", "vy", "vz", "h", "du"):
        fields[f] = rng.uniform(-1.0, 2.0, n).astype(np.float32)
    rho = rng.uniform(0.5, 3.0, n).astype(np.float32)
    js = dataclasses.replace(js, **{f: jnp.asarray(fields[f]) for f in
                                    ("x", "y", "z", "m", "temp", "vx", "vy", "vz", "h", "du")})
    box = {"lo": np.array(jb.lo), "hi": np.array(jb.hi),
           "boundaries": [int(b) for b in jb.boundaries]}
    ts, tb, _ = state_from_numpy(fields, box, dataclasses.asdict(jc), device="cpu")
    return (js, jnp.asarray(rho), jb), (ts, torch.from_numpy(rho), tb)


SPECS = {
    "sum_z": dict(fields=("rho", "temp"), grid=9, axis=2),
    "sum_x": dict(fields=("rho", "m"), grid=8, axis=0),
    "sum_y": dict(fields=("vx", "h", "du"), grid=7, axis=1),
    "max_z": dict(fields=("rho", "vy"), grid=9, axis=2, reduce="max"),
    "volume": dict(fields=("m", "temp"), grid=5, volume=True),
    "volume_max": dict(fields=("vz",), grid=4, volume=True, reduce="max"),
    "stride": dict(fields=SNAP_FIELDS, grid=6, stride=7),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_snapshot_diagnostics_matches_jax(name):
    kw = SPECS[name]
    (js, jrho, jb), (ts, trho, tb) = _seeded_state()
    j = jax.jit(lambda s, r, b: jax_snapshot(s, r, b, JaxSpec(**kw)))(js, jrho, jb)
    t = snapshot_diagnostics(ts, trho, tb, SnapshotSpec(**kw))
    assert sorted(t) == sorted(j)
    jg, tg = np.asarray(j["snap_grid"]), t["snap_grid"].numpy()
    assert tg.shape == jg.shape and tg.dtype == jg.dtype
    if kw.get("reduce") == "max":
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(t["snap_min"].numpy(), np.asarray(j["snap_min"]))
        np.testing.assert_array_equal(t["snap_max"].numpy(), np.asarray(j["snap_max"]))
    else:
        scale = np.abs(jg).reshape(jg.shape[0], -1).max(axis=1)
        for f in range(jg.shape[0]):
            np.testing.assert_allclose(tg[f], jg[f], rtol=0, atol=1e-6 * scale[f])
        np.testing.assert_allclose(t["snap_min"].numpy(), np.asarray(j["snap_min"]),
                                   rtol=0, atol=1e-6 * scale.max())
        np.testing.assert_allclose(t["snap_max"].numpy(), np.asarray(j["snap_max"]),
                                   rtol=0, atol=1e-6 * scale.max())
    if "snap_pts" in j:
        np.testing.assert_array_equal(t["snap_pts"].numpy(), np.asarray(j["snap_pts"]))


BAD_SPECS = [dict(fields=()), dict(fields=("rho", "pressure")), dict(grid=1), dict(axis=3),
             dict(reduce="mean"), dict(stride=-1)]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=lambda kw: ",".join(kw))
def test_spec_errors_match_jax(kw):
    with pytest.raises(ValueError) as je:
        JaxSpec(**kw)
    with pytest.raises(ValueError) as te:
        SnapshotSpec(**kw)
    assert str(te.value) == str(je.value)


def _frames(sim):
    out = []
    for it, path in sim.drain_snapshots():
        with np.load(path) as f:
            out.append((it, {k: f[k] for k in f.files}))
    return out


def test_simulation_frames_match_jax(tmp_path):
    """Sedov 8, three steps, a frame every step: the port's ring against
    the JAX Simulation's."""
    kw = dict(fields=("rho", "temp"), grid=15)
    js, jb, jc = jax_init_sedov(8)
    jsim = JaxSimulation(js, jb, jc, prop="std", snap_spec=JaxSpec(**kw),
                         snap_dir=str(tmp_path / "jax"))
    st, box, const = init_sedov(8, device="cpu")
    tsim = Simulation(st, box, const, device="cpu", snap_spec=SnapshotSpec(**kw),
                      snap_dir=str(tmp_path / "torch"))
    for _ in range(3):
        jsim.step()
        tsim.step()
    jf, tf = _frames(jsim), _frames(tsim)
    assert [it for it, _ in tf] == [it for it, _ in jf] == [1, 2, 3]
    for (_, a), (_, b) in zip(tf, jf):
        assert sorted(a) == sorted(b)
        np.testing.assert_allclose(a["grid"], b["grid"], rtol=1e-5)
        assert a["grid"].dtype == b["grid"].dtype
        for k in ("it", "fields", "axis", "reduce", "volume"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_allclose(a["lo"], b["lo"])
        np.testing.assert_allclose(a["lengths"], b["lengths"])


def _run_frames(check_every: int, tmp_path, **kw):
    st, box, const = init_sedov(8, device="cpu")
    sink = MemorySink()
    sim = Simulation(st, box, const, device="cpu", use_lists=False, check_every=check_every,
                     snap_spec=SnapshotSpec(fields=("rho", "temp"), grid=7),
                     snap_dir=str(tmp_path / f"ce{check_every}"), snap_every=2,
                     telemetry=Telemetry(sinks=[sink]), **kw)
    return sim, sink


def test_deferred_frames_equal_checked_with_one_read_a_window(tmp_path, monkeypatch):
    ref, _ = _run_frames(1, tmp_path)
    for _ in range(8):
        ref.step()
    sim, sink = _run_frames(4, tmp_path)
    reads = []
    fetch = Simulation._fetch_scalars
    monkeypatch.setattr(Simulation, "_fetch_scalars",
                        lambda self, entries: reads.append(len(entries)) or fetch(self, entries))
    for _ in range(8):
        sim.step()
    assert reads == [4, 4]  # one read a window, every step of it
    a, b = _frames(sim), _frames(ref)
    assert [it for it, _ in a] == [it for it, _ in b] == [2, 4, 6, 8]
    for (_, fa), (_, fb) in zip(a, b):
        np.testing.assert_array_equal(fa["grid"], fb["grid"])
    assert [e["it"] for e in sink.of_kind("snapshot")] == [2, 4, 6, 8]


def test_rolled_back_window_writes_no_frame_twice(tmp_path):
    """The cap forced to 8 before a window (kernels/deferred_checks.py's
    cap rollback): the flush rolls the window back and replays it; the
    frames and snapshot events of its steps come once, from the replay."""
    sim, sink = _run_frames(4, tmp_path)
    sim._cfg = dataclasses.replace(sim._cfg, nbr=dataclasses.replace(sim._cfg.nbr, cap=8))
    for _ in range(4):
        sim.step()
    assert sim.rollbacks == 1
    assert [it for it, _ in sim.drain_snapshots()] == [2, 4]
    assert [e["it"] for e in sink.of_kind("snapshot")] == [2, 4]
    ref, _ = _run_frames(1, tmp_path / "ref")
    for _ in range(4):
        ref.step()
    assert [it for it, _ in ref.drain_snapshots()] == [2, 4]


def test_two_ranks_match_one_device(tmp_path):
    """The CLI's --devices 2 on gloo ranks: rank 0 writes every frame (one
    snapshot event per frame), and the step-2 grid of m and temp, reduced
    over the ranks inside the step's gather, equals the one-device
    deposit of the same particles (the ranks' --ascii dump at step 2,
    kernels/app_checks.py ``grid_vs_dump``), and the JAX package's."""
    out, tel, trace = tmp_path / "out", tmp_path / "tel", tmp_path / "trace"
    cmd = [sys.executable, "-m", "sphexa_torch.app.main", "--init", "sedov", "-n", "10",
           "-s", "2", "-w", "2", "--ascii", "--check-every", "2", "--devices", "2",
           "--device", "cpu", "--snap", "m,temp", "--snap-grid", "15", "-o", str(out),
           "--telemetry-dir", str(tel), "--quiet", "--insitu", "projection", "--profile",
           "--trace-dir", str(trace)]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert sorted(os.listdir(tel / "snapshots")) == ["snap_000001.npz", "snap_000002.npz"]
    # rank 0 renders and writes profile.npz (no substeps on a mesh); a trace a rank
    assert sorted(f for f in os.listdir(out) if f.endswith((".png", ".npz"))) == [
        "insitu_projection_000001.png", "insitu_projection_000002.png", "profile.npz"]
    assert not [k for k in np.load(out / "profile.npz").files if k.startswith("substep_")]
    assert sorted(os.listdir(trace)) == ["rank0.pt.trace.json", "rank1.pt.trace.json"]
    events = [json.loads(line) for line in open(tel / "events.jsonl")]
    assert [e["it"] for e in events if e["kind"] == "snapshot"] == [1, 2]
    assert [e["kind"] for e in events].count("phase_attr") == 1
    spec = SnapshotSpec(fields=("m", "temp"), grid=15)
    frame, dump = tel / "snapshots" / "snap_000002.npz", out / "dump_sedov_it2.txt"
    grid_vs_dump("two ranks", str(frame), str(dump), spec, "cpu")
    with np.load(frame) as f:
        grid, lo, lengths = f["grid"], f["lo"], f["lengths"]
    with open(dump) as f:
        names = f.readline().lstrip("#").split()
    cols = dict(zip(names, np.loadtxt(dump, unpack=True)))
    js, jb, _ = jax_init_sedov(10)
    js = dataclasses.replace(js, **{k: jnp.asarray(cols[k].astype(np.float32))
                                    for k in ("x", "y", "z", "m", "temp")})
    jb = dataclasses.replace(jb, lo=jnp.asarray(lo.astype(np.float32)),
                             hi=jnp.asarray((lo + lengths).astype(np.float32)))
    jg = np.asarray(jax_snapshot(js, jnp.zeros_like(js.x), jb,
                                 JaxSpec(fields=("m", "temp"), grid=15))["snap_grid"])
    np.testing.assert_allclose(grid, jg, rtol=1e-6, atol=1e-12)
    # the grid conserves the deposited mass
    np.testing.assert_allclose(grid[0].sum(), cols["m"].sum(), rtol=1e-6)
