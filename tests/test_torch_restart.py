"""Restart from a dump in the port: the restarted Simulation takes the
unbroken run's next step (tests/test_io.py:131-148's contract: dt within
rel 1e-6, x within atol 1e-7), a port dump restarted by the port and by
the JAX package (Pallas in interpret mode, list mode) steps alike, and
the CLI's restart bookkeeping (tests/test_app_tail.py:174-222 on the
port's CLI): dumps appended under the case's name, constants.txt cut at
the restart point and monotonic, the float -w schedule's catch-up,
--wextra, --duration, -f and --ascii.

Tolerances of the JAX comparison: tests/test_torch_deferred.py's
list-mode ones (x rtol 2e-6, temp and vx 1e-4, atol 1e-7), the fields
compared order-insensitively (the two runs sort on their own)."""

import dataclasses
import os

import h5py
import numpy as np
import pytest
import torch

from sphexa_tpu.io import read_snapshot as jax_read_snapshot
from sphexa_tpu.simulation import Simulation as JaxSimulation

from sphexa_torch.app import main as app
from sphexa_torch.init import init_noh, init_sedov
from sphexa_torch.init.file_init import init_from_file
from sphexa_torch.io import list_steps, read_snapshot_full, write_snapshot
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.simulation import Simulation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("case,side,lists", [("sedov", 8, False), ("noh", 14, True)])
def test_restart_takes_the_unbroken_runs_next_step(tmp_path, case, side, lists):
    init = {"sedov": init_sedov, "noh": init_noh}[case]
    sim = Simulation(*init(side, device="cpu"), device="cpu", obs_spec=ObservableSpec())
    for _ in range(3):
        sim.step()
    assert (sim.lists is not None) == lists
    path = str(tmp_path / "ckpt.h5")
    write_snapshot(path, sim.state, sim.box, sim.const, iteration=sim.iteration)

    sim2 = Simulation(*init_from_file(path, device="cpu"), device="cpu",
                      obs_spec=ObservableSpec())
    sim2.iteration = sim.iteration
    d_orig, d_rest = sim.step(), sim2.step()
    assert d_rest["dt"] == pytest.approx(d_orig["dt"], rel=1e-6)
    np.testing.assert_allclose(np.sort(sim2.state.x.numpy()), np.sort(sim.state.x.numpy()),
                               rtol=0, atol=1e-7)
    # the restarted run counts on from the dump, and its drift baseline is
    # its first step
    assert sim2.iteration == 4 and sim2.energy_drift == 0.0


def test_port_dump_steps_alike_in_both_packages(tmp_path):
    sim = Simulation(*init_noh(14, device="cpu"), device="cpu")
    for _ in range(3):
        sim.step()
    path = str(tmp_path / "ckpt.npz")
    write_snapshot(path, sim.state, sim.box, sim.const, iteration=sim.iteration, case="noh")

    state, box, const, _, attrs = read_snapshot_full(path, device="cpu")
    port = Simulation(state, box, const, device="cpu")
    js, jb, jc, _ = jax_read_snapshot(path)
    jsim = JaxSimulation(js, jb, jc, prop="std", backend="pallas", use_lists=True)
    for _ in range(2):
        port.step()
        jsim.step()
    assert port.lists is not None
    s0, s1 = jsim.state, port.state
    assert float(s1.ttot) == pytest.approx(float(s0.ttot), rel=1e-6)
    for f, tol in (("x", 2e-6), ("y", 2e-6), ("h", 2e-6), ("temp", 1e-4), ("vx", 1e-4)):
        np.testing.assert_allclose(np.sort(getattr(s1, f).numpy()),
                                   np.sort(np.asarray(getattr(s0, f))),
                                   rtol=tol, atol=1e-7, err_msg=f)


def _its(out):
    rows = [ln for ln in open(f"{out}/constants.txt") if not ln.startswith("#")]
    return [int(float(ln.split()[0])) for ln in rows]


def _cli(*argv):
    assert app.main([*argv, "--device", "cpu", "--quiet"]) == 0


def test_restart_appends_to_case_dump_and_truncates_constants(tmp_path):
    out = str(tmp_path)
    _cli("--init", "sedov", "-n", "8", "-s", "4", "-w", "2", "-o", out)
    dump = f"{out}/dump_sedov.h5"
    assert list_steps(dump) == [0, 1] and _its(out) == [1, 2, 3, 4]
    with h5py.File(dump, "r") as f:
        assert {"rho", "p", "c", "u", "vel", "r"} <= set(f["Step#0"].keys())
        assert int(f["Step#1"].attrs["iteration"]) == 4

    # restart from Step#0 (iteration 2): Step#n groups appended under the
    # same name, constants.txt cut after iteration 2 and continued to 6
    _cli("--init", f"{dump}:0", "-s", "6", "-w", "2", "-o", out)
    assert list_steps(dump) == [0, 1, 2, 3]
    with h5py.File(dump, "r") as f:
        assert [int(f[f"Step#{k}"].attrs["iteration"]) for k in range(4)] == [2, 4, 4, 6]
        assert f["Step#3"].attrs["initCase"] == b"sedov"
    assert not [p for p in os.listdir(out)
                if p.startswith("dump_") and p != "dump_sedov.h5"]
    assert _its(out) == [1, 2, 3, 4, 5, 6]


def test_float_w_schedule_catches_up(tmp_path):
    # each step crosses many 1e-9 intervals: one dump a step, no burst
    out = str(tmp_path)
    _cli("--init", "sedov", "-n", "8", "-s", "3", "-w", "1e-9", "-o", out)
    assert list_steps(f"{out}/dump_sedov.h5") == [0, 1, 2]


def test_wextra_duration_fields_and_ascii(tmp_path):
    out = str(tmp_path)
    # an iteration trigger and a time trigger (t passes 3e-6 at iteration 3)
    _cli("--init", "sedov", "-n", "8", "-s", "5", "--wextra", "2,3e-6", "-f", "rho", "-o", out)
    dump = f"{out}/dump_sedov.h5"
    with h5py.File(dump, "r") as f:
        assert [int(f[k].attrs["iteration"]) for k in sorted(f.keys())] == [2, 3]
        assert set(f["Step#0"].keys()) == {"rho", "x", "y", "z", "x_m1", "y_m1", "z_m1",
                                           "vx", "vy", "vz", "h", "m", "temp", "du",
                                           "du_m1", "alpha"}
    # --duration 0: the run stops after its first step, with a final dump
    _cli("--init", "sedov", "-n", "8", "-s", "5", "-w", "4", "--duration", "0", "-o", out)
    assert list_steps(dump) == [0] and _its(out) == [1]
    _cli("--init", "sedov", "-n", "6", "-s", "2", "-w", "1", "--ascii", "-o", out)
    data = np.loadtxt(f"{out}/dump_sedov_it2.txt")
    assert data.shape == (216, 21)
    assert open(f"{out}/dump_sedov_it1.txt").readline().startswith("# x y z x_m1")
    assert app.main(["--init", "sedov", "-n", "6", "--wextra", "two", "--device", "cpu",
                     "-o", out, "--quiet"]) == 2


def test_cli_restarts_from_an_npz_dump_under_deferral(tmp_path):
    """The card's path: a dump written through the library as .npz, the
    CLI restarted from it with a deferred window; --sym-pairs overrides
    the dump's convention."""
    sim = Simulation(*init_sedov(8, device="cpu"), device="cpu", obs_spec=ObservableSpec())
    for _ in range(3):
        sim.step()
    path = str(tmp_path / "ckpt.npz")
    const = dataclasses.replace(sim.const, sym_pairs=False)
    write_snapshot(path, sim.state, sim.box, const, iteration=sim.iteration, case="sedov")
    out = str(tmp_path / "out")
    _cli("--init", path, "-s", "7", "--check-every", "3", "--sym-pairs", "on", "-o", out)
    assert _its(out) == [4, 5, 6, 7]


def test_io_checks_on_the_cpu(tmp_path):
    """The card's io_restart checks (sphexa_torch/kernels/io_checks.py)
    at a small size on the CPU: Noh 14 in list mode dumped at step 3 and
    restarted beside the unbroken run to step 6, the output fields against
    their plain versions, a short reference-configuration run of each
    kind, and the CLI restarted from the dump in a process of its own."""
    from sphexa_torch.kernels import io_checks

    r = io_checks.restart_vs_unbroken("noh", 14, "cpu", str(tmp_path), dump_at=3, to_step=6,
                                      spec=ObservableSpec())
    assert r["first_step"]["dt_rel"] <= 1e-6 and r["worst"] <= io_checks.RESTART_BOUND
    assert r["dump_bytes"] > 0 and set(r["field_diff"]) == {"restart", "rebuild", "temp_lo"}
    state, box, cfg = r["restored"]
    for pipeline in ("std", "ve"):
        errs = io_checks.output_fields_vs_plain("noh 14", state, box, cfg, pipeline)
        assert all(v == 0.0 for v in errs.values())
    for case, prop in (("sedov", "std"), ("sedov", "ve"), ("noh", "std")):
        res = io_checks.l1_reference(case, prop, 8 if case == "sedov" else 12, steps=4,
                                     device="cpu", check_every=2)
        assert np.isfinite(res["drift"]) and res["steps"] == 4
        assert isinstance(io_checks.l1_misses(res), list)
    cli = io_checks.cli_restart(r["path"], str(tmp_path / "cli"), to_step=6, device="cpu",
                                check_every=2)
    assert cli["rows"] == [4, 6] and cli["bytes_in_use"] == [] and cli["windows"] >= 1
