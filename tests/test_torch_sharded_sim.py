"""The driver, the CLI and the dumps across ranks (gloo ranks on the CPU,
``sphexa_torch.parallel.mesh.spawn``):

- ``Simulation(num_devices=2)`` with deferred windows (check_every 4)
  against the one-device streaming ``Simulation``: the science ledger's
  energies and momenta within 1e-10 relative, step for step, dt and the
  final positions too; std and VE, both halo modes;
- an undersized halo (the sizing's margin below 1): the escape sentinel
  trips, the window rolls back, the margin regrows and the replay lands
  on the well-sized run's result;
- the CLI's ``--devices 2 --device cpu``: constants.txt written once
  (rank 0), the sharded dumps, and a restart from them with the same P
  (the CLI) and another P (one device);
- ``write_snapshot_sharded``'s part files read back by the JAX package's
  reader and the port's.
"""

import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from sphexa_tpu.io.snapshot import read_snapshot as jax_read_snapshot

from sphexa_torch.convert import state_to_numpy
from sphexa_torch.init import init_sedov
from sphexa_torch.io import read_snapshot, write_snapshot_sharded
from sphexa_torch.kernels import sharded_checks as sc
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.parallel.mesh import Mesh, spawn
from sphexa_torch.simulation import Simulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the ledger's energies (and t, dt) are held to 1e-10 of the total
#: energy: where a run crosses a slab boundary the ranks split it and sum
#: its candidates in another float32 order, so the kinetic energy, a
#: part in 1e8 of the total after a step, differs from the one-device
#: run's by about its float32 round-off; etot itself agrees to float64
#: round-off. The momenta's norms are cancellation residue (about 1e-13
#: from terms of 1e-6): held to 1e-6 of sqrt(2 M ecin), the momentum of
#: the kinetic energy (M = 1 in Sedov)
LEDGER = ("etot", "ecin", "eint", "t", "dt")
MOMENTA = ("linmom", "angmom")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _one_device(side, steps, **kw):
    state, box, const = init_sedov(side, device="cpu")
    sim = Simulation(state, box, const, device="cpu", use_lists=False,
                     obs_spec=ObservableSpec(), science_rows=True, **kw)
    sim.run(steps)
    return sim


def _rows_close(rows, ref, rel=1e-10):
    assert [r["it"] for r in rows] == [r["it"] for r in ref]
    for a, b in zip(rows, ref):
        for k in LEDGER:
            scale = abs(b["etot"]) if k in ("ecin", "eint") else abs(b[k])
            assert abs(a[k] - b[k]) <= rel * scale, (a["it"], k, a[k], b[k])
        for k in MOMENTA:
            assert abs(a[k] - b[k]) <= 1e-6 * np.sqrt(2.0 * b["ecin"]), (a["it"], k, a[k], b[k])


def test_simulation_matches_one_device_and_regrows_the_halo(tmp_path):
    flat12 = state_to_numpy(*init_sedov(12, device="cpu"))
    flat16 = state_to_numpy(*init_sedov(16, device="cpu"))
    runs = [(flat12, {"prop": "std", "halo_mode": "sparse", "check_every": 4}, 8),
            (flat12, {"prop": "ve", "av_clean": True, "halo_mode": "sparse",
                      "check_every": 4, "halo_margin": 0.5}, 4),
            (flat16, {"prop": "std", "halo_mode": "windowed", "check_every": 4,
                      "halo_margin": 0.4}, 4)]
    with ThreadPoolExecutor(1) as pool:
        # the ranks run while this process steps the one-device references
        ranks = pool.submit(spawn, sc.rank_simulation, 2, args=(runs,), workdir=str(tmp_path),
                            device="cpu", threads=1, timeout=300)
        refs = [_one_device(12, 8, prop="std", check_every=4),
                _one_device(12, 4, prop="ve", av_clean=True, check_every=4),
                _one_device(16, 4, prop="std", check_every=4)]
        out = ranks.result()
    for i, ((_, kw, _), ref) in enumerate(zip(runs, refs)):
        r0, r1 = out[0][i], out[1][i]
        assert r0["rows"] == r1["rows"]  # every rank holds the same replicated scalars
        _rows_close(r0["rows"], ref.drain_science())
        x = np.concatenate([r0["x"], r1["x"]])
        np.testing.assert_allclose(x, ref.state.x.numpy(), rtol=1e-5, atol=1e-7)
        assert "shard_load" in r0["kinds"] and "exchange" in r0["kinds"]
        if "halo_margin" in kw:
            # the undersized halo tripped: the window rolled back, the
            # margin grew, the replay ran on a wider halo
            assert r0["rollbacks"] >= 1 and r0["replays"] >= 1, r0
            assert r0["reconfigures"] >= 2
        else:
            assert r0["replays"] == 0 and r0["rollbacks"] == 0
    S = 12 ** 3 // 2
    assert out[0][1]["halo"]["mode"] == "sparse" and max(out[0][1]["halo"]["caps"]) <= S
    assert out[0][2]["halo"]["mode"] == "windowed"


def _cli(args, cwd):
    env = {**os.environ, "PYTHONPATH": ROOT}
    return subprocess.run([sys.executable, "-m", "sphexa_torch.app.main", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def _constants(path):
    rows = np.loadtxt(path, ndmin=2)
    return [{"it": int(r[0]), "t": r[1], "dt": r[2], "etot": r[3], "ecin": r[4], "eint": r[5]}
            for r in rows]


def test_cli_devices_dumps_and_restart(tmp_path):
    out = tmp_path / "run"
    p = _cli(["--init", "sedov", "-n", "12", "-s", "4", "-w", "2", "--devices", "2",
              "--device", "cpu", "-o", str(out), "--telemetry-dir", str(out / "tel")], tmp_path)
    assert p.returncode == 0, p.stderr
    # rank 0 alone prints and writes constants.txt: every row once
    assert p.stdout.count("it     3  t=") == 1
    rows = _constants(out / "constants.txt")
    assert [r["it"] for r in rows] == [1, 2, 3, 4]
    ref = _one_device(12, 4, prop="std")
    for a, b in zip(rows, ref.drain_science()):
        # constants.txt holds 10 significant digits
        assert abs(a["etot"] - b["etot"]) <= 1e-9 * abs(b["etot"]), (a, b)
    base = out / "dump_sedov.h5"
    assert sorted(os.listdir(out)) == ["constants.txt", "dump_sedov.part000of002.h5",
                                       "dump_sedov.part001of002.h5", "tel"]
    events = (out / "tel" / "events.jsonl").read_text()
    assert '"kind":"exchange"' in events and '"kind":"shard_load"' in events

    # the same P through the CLI, another P (one device) through the library
    again = tmp_path / "again"
    p = _cli(["--init", f"{base}:0", "-s", "4", "--devices", "2", "--device", "cpu",
              "-o", str(again)], tmp_path)
    assert p.returncode == 0, p.stderr
    restarted = _constants(again / "constants.txt")
    assert [r["it"] for r in restarted] == [3, 4]
    state, box, const, _ = read_snapshot(f"{base}", step=0, device="cpu")
    assert state.n == 12 ** 3
    sim = Simulation(state, box, const, device="cpu", use_lists=False,
                     obs_spec=ObservableSpec(), science_rows=True)
    sim.iteration = 2
    sim.run(2)
    for a, b in zip(restarted, sim.drain_science()):
        assert a["it"] == b["it"]
        assert abs(a["etot"] - b["etot"]) <= 1e-9 * abs(b["etot"]), (a, b)


def test_write_snapshot_sharded_parts_read_by_both_packages(tmp_path):
    state, box, const = init_sedov(8, device="cpu")
    P, S = 4, state.n // 4
    path = str(tmp_path / "dump.h5")
    for k in range(P):
        mesh = Mesh(group=None, rank=k, size=P, device=torch.device("cpu"), backend="gloo")
        slab = dataclasses.replace(state, **{
            f.name: getattr(state, f.name)[k * S:(k + 1) * S]
            for f in dataclasses.fields(state) if getattr(state, f.name).dim() == 1})
        write_snapshot_sharded(path, slab, box, const, iteration=5, case="sedov", mesh=mesh,
                               extra_fields={"rho": slab.m * 2.0})
    assert len([f for f in os.listdir(tmp_path) if ".part" in f]) == P
    js, jbox, _, jextra = jax_read_snapshot(path)
    ts, tbox, _, textra = read_snapshot(path, device="cpu")
    assert js.n == ts.n == state.n
    for f in ("x", "y", "z", "h", "m", "temp", "vx", "alpha"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(state, f).numpy())
        np.testing.assert_array_equal(getattr(ts, f).numpy(), getattr(state, f).numpy())
    np.testing.assert_array_equal(np.asarray(jextra["rho"]), (state.m * 2.0).numpy())
    np.testing.assert_array_equal(textra["rho"], (state.m * 2.0).numpy())
