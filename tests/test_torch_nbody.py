"""The port's N-body propagator against the JAX package's, on the CPU (the
port's plain versions; the JAX package's near field through its Pallas
kernel in interpret mode): three ``Simulation(prop="nbody")`` steps on
Evrard 16 and on a 4,096-particle Plummer sphere from the same input,
``sample_plummer`` bit for bit, the CLI's ``--prop nbody`` rows of
constants.txt against the JAX CLI's, and the refusals.

Tolerances: tests/test_torch_gravity_slice.py's, the fields rtol 2e-4 /
atol 5e-6 x max|.|, egrav, dt and the ledger's energies rel 1e-4, the
integer diagnostics (the interaction-list high waters, the dt limiter,
the zero neighbour counts) exact."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.app import main as jax_app
from sphexa_tpu.init import init_evrard as jax_init_evrard
from sphexa_tpu.init.plummer import sample_plummer as jax_sample_plummer
from sphexa_tpu.init.utils import build_state as jax_build_state
from sphexa_tpu.observables.ledger import ObservableSpec as JaxSpec
from sphexa_tpu.sfc.box import BoundaryType as JaxBoundary
from sphexa_tpu.sfc.box import Box as JaxBox
from sphexa_tpu.simulation import Simulation as JaxSimulation
from sphexa_tpu.sph.particles import SimConstants as JaxConstants

from sphexa_torch.app import main as app
from sphexa_torch.convert import state_to_numpy
from sphexa_torch.init import init_evrard, init_sedov
from sphexa_torch.init.plummer import plummer_state, sample_plummer
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.propagator import _step_nbody
from sphexa_torch.simulation import Simulation

INT_DIAGS = ("m2p_max", "p2p_max", "leaf_occ", "c_max", "dt_limiter", "occupancy", "nc_max",
             "n_nc_clip", "n_h_sat", "n_bad_rho", "n_bad_h", "n_bad_du")
PLUMMER_N = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_plummer(n):
    """The JAX package's cold Plummer sphere as its gravity benchmark
    builds it (bench.py ``_gravity_scale_line``): h 1e-3, the open cube
    1.001 x the largest coordinate, G = 1."""
    x, y, z, m = jax_sample_plummer(n)
    ext = float(np.max(np.abs(np.stack([x, y, z])))) * 1.001
    const = JaxConstants(g=1.0).normalized()
    state = jax_build_state(x, y, z, 0.0, 0.0, 0.0, 1e-3, m, 0.0, 1e-4, const.alphamin)
    return state, JaxBox.create(-ext, ext, boundary=JaxBoundary.open), const


@pytest.mark.parametrize("n,seed", [(1000, 3), (PLUMMER_N, 3), (777, 11)])
def test_sample_plummer_matches_jax(n, seed):
    for a, b in zip(sample_plummer(n, seed=seed), jax_sample_plummer(n, seed=seed)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_plummer_state_matches_jax():
    state, box, const = plummer_state(PLUMMER_N, device="cpu")
    js, jb, jc = _jax_plummer(PLUMMER_N)
    fields, b, _ = state_to_numpy(state, box, const)
    for f in dataclasses.fields(js):
        np.testing.assert_array_equal(fields[f.name], np.asarray(getattr(js, f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(b["lo"], np.asarray(jb.lo))
    np.testing.assert_array_equal(b["hi"], np.asarray(jb.hi))
    assert const.g == jc.g == 1.0 and b["boundaries"] == [0, 0, 0]


def _cases(name):
    if name == "evrard16":
        return jax_init_evrard(16), init_evrard(16, device="cpu")
    return _jax_plummer(PLUMMER_N), plummer_state(PLUMMER_N, device="cpu")


@pytest.mark.parametrize("case", ["evrard16", "plummer4096"])
def test_nbody_simulation_matches_jax(case):
    """Three steps of each package's Simulation(prop="nbody") from the
    same input: the same caps, the same high waters, dt and egrav, the
    ledger's energies, and every field elementwise (both sort by the
    same keys)."""
    (js, jb, jc), (ts, tb, tc) = _cases(case)
    jsim = JaxSimulation(js, jb, jc, prop="nbody", backend="pallas", check_every=1,
                         obs_spec=JaxSpec())
    sim = Simulation(ts, tb, tc, prop="nbody", device="cpu", obs_spec=ObservableSpec())
    assert sim.gravity_on and not sim.ewald_on and sim.lists is None
    for k in ("m2p_cap", "p2p_cap", "leaf_cap", "target_block", "super_factor",
              "compaction", "theta"):
        assert getattr(sim.cfg.gravity, k) == getattr(jsim._cfg.gravity, k), k
    for it in range(3):
        jd, td = jsim.step(), sim.step()
        for k in INT_DIAGS:
            assert td[k] == float(jd[k]), (it, k)
        assert td["nc_mean"] == float(jd["nc_mean"]) == 1.0
        for k in ("dt", "egrav", "obs_etot", "obs_ecin", "obs_egrav"):
            assert td[k] == pytest.approx(float(jd[k]), rel=1e-4), (it, k)
    assert float(td["egrav"]) < 0.0
    out, _, _ = state_to_numpy(sim.state, sim.box, sim.const)
    for f in dataclasses.fields(jsim.state):
        a, b = out[f.name], np.asarray(getattr(jsim.state, f.name))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-6 * float(np.max(np.abs(b))),
                                   err_msg=f.name)
    # no hydro: h and the internal energy stay where they started
    torch.testing.assert_close(torch.sort(sim.state.h).values, torch.sort(ts.h).values)
    assert sim.energy_drift is not None and sim.energy_drift < 1e-4


def test_nbody_refusals():
    state, box, const = init_sedov(6, device="cpu")
    with pytest.raises(ValueError, match="needs a gravitational constant"):
        Simulation(state, box, const, prop="nbody", device="cpu")
    sim = Simulation(*init_evrard(8, device="cpu"), prop="nbody", device="cpu")
    with pytest.raises(ValueError, match="no neighbour lists"):
        _step_nbody(sim.state, sim.box, sim.cfg, sim.gtree, lists=object())


def _rows(path):
    return np.loadtxt(path, comments="#", ndmin=2)


def test_cli_nbody_constants_match_jax(tmp_path, capsys):
    """``--prop nbody`` through both CLIs: the same constants.txt columns
    and rows, the values within rel 1e-4."""
    argv = ["--init", "evrard", "-n", "10", "-s", "3", "--prop", "nbody", "--theta", "0.6",
            "--m2p-cap-margin", "1.5"]
    assert jax_app.main(argv + ["-o", str(tmp_path / "jax")]) == 0
    assert app.main(argv + ["-o", str(tmp_path / "port"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "it     3" in out and "egrav=-" in out and "lists off" in out
    heads = [open(os.path.join(tmp_path, d, "constants.txt")).readline() for d in ("jax", "port")]
    assert heads[0] == heads[1]
    a, b = (_rows(tmp_path / d / "constants.txt") for d in ("port", "jax"))
    assert a.shape == b.shape == (3, 7)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=1e-4, atol=1e-12)
