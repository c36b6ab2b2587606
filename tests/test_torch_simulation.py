"""The port's driver on the CPU: a 5-step Sedov run against the JAX
package's conserved quantities, the overflow contract (re-size and replay
from the step's input), the card-by-default device rule, and the CLI (std
Sedov and Noh, VE Gresho-Chan)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.observables.conserved import conserved_quantities as jax_conserved
from sphexa_tpu.propagator import step_hydro_std as jax_step
from sphexa_tpu.simulation import make_propagator_config as jax_config

from sphexa_torch.app import main as app
from sphexa_torch.init import init_sedov
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.observables.conserved import conserved_quantities
from sphexa_torch.simulation import Simulation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_five_steps_conserved_quantities():
    """Each package evolves its own state for 5 steps from the same
    initial conditions; energies agree to float32 accumulation (the JAX
    package sums in float32 without x64), momentum to the rounding scale
    of sum m|v|."""
    js, jb, jc = jax_init_sedov(12)
    jcfg = jax_config(js, jb, jc, backend="pallas")
    for _ in range(5):
        js, jb, _ = jax_step(js, jb, jcfg)
    cj = {k: float(v) for k, v in jax_conserved(js, jc).items()}

    sim = Simulation(*init_sedov(12, device="cpu"), device="cpu", obs_spec=ObservableSpec())
    sim.run(5)
    ct = {k: float(v) for k, v in conserved_quantities(sim.state, sim.const).items()}
    assert ct["etot"] == pytest.approx(cj["etot"], rel=1e-6)
    assert ct["eint"] == pytest.approx(cj["eint"], rel=1e-6)
    assert ct["ecin"] == pytest.approx(cj["ecin"], rel=1e-4)
    mom_scale = float(torch.sum(sim.state.m * sim.state.vx.abs()))
    assert abs(ct["linmom"] - cj["linmom"]) <= 1e-5 * mom_scale
    assert sim.energy_drift is not None and abs(sim.energy_drift) < 1e-6
    assert sim.iteration == 5 and sim.reconfigures == 0


@pytest.mark.parametrize("broken", ["cap", "window"])
def test_overflow_resizes_and_replays(broken):
    """A step whose occupancy exceeds the cap (a small cap) or reports the
    cap + 1 window sentinel (a window of one cell) is discarded, the
    config re-sized, and the step replayed from its saved input: the
    result equals a clean run's step exactly."""
    ref = Simulation(*init_sedov(12, device="cpu"), device="cpu", cell_target=16,
                     obs_spec=ObservableSpec())
    want = ref.step()

    sim = Simulation(*init_sedov(12, device="cpu"), device="cpu", cell_target=16,
                     obs_spec=ObservableSpec())
    good = sim.cfg
    field = {"cap": 8} if broken == "cap" else {"window": 1}
    sim._cfg = dataclasses.replace(good, nbr=dataclasses.replace(good.nbr, **field))
    got = sim.step()
    assert sim.replays == 1 and sim.reconfigures == 1
    assert dataclasses.asdict(sim.cfg.nbr) == dataclasses.asdict(good.nbr)
    assert got["occupancy"] <= sim.cfg.nbr.cap
    for k in ("dt", "nc_mean", "obs_etot", "rho_max"):
        assert got[k] == want[k], k
    torch.testing.assert_close(sim.state.x, ref.state.x, rtol=0, atol=0)
    torch.testing.assert_close(sim.state.temp, ref.state.temp, rtol=0, atol=0)


def test_card_by_default():
    """Entry points run on the card unless device="cpu" is given; without
    a card they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        state, box, const = init_sedov(4)
        assert state.x.is_cuda
        assert Simulation(state, box, const).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_sedov(4)
        state, box, const = init_sedov(4, device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Simulation(state, box, const)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.main(["--init", "sedov", "-n", "4", "-s", "1"])
    with pytest.raises(ValueError, match="unknown propagator 'blockdt'"):
        Simulation(*init_sedov(4, device="cpu"), prop="blockdt", device="cpu")


def test_cli_runs_on_cpu(capsys, tmp_path):
    out_dir = ["-o", str(tmp_path)]
    assert app.main(["--init", "sedov", "-n", "6", "-s", "2", "--device", "cpu", *out_dir]) == 0
    out = capsys.readouterr().out
    assert "it     2" in out and "etot=" in out and "nc~" in out
    assert app.main(["--init", "noh", "-n", "8", "-s", "2", "--device", "cpu", *out_dir]) == 0
    out = capsys.readouterr().out
    assert "it     2" in out and "lists on" in out
    assert app.main(["--init", "gresho-chan", "-n", "20", "-s", "3", "--prop", "ve",
                     "--device", "cpu", *out_dir]) == 0
    out = capsys.readouterr().out
    assert "it     3" in out and "drift=" in out
    assert app.main(["--init", "evrard", "-n", "12", "-s", "2", "--prop", "ve",
                     "--device", "cpu", *out_dir]) == 0
    out = capsys.readouterr().out
    assert "it     2" in out and "egrav=-" in out and "lists off" in out
    assert app.main(["--init", "kelvin-helmholtz", "-n", "12", "-s", "2", "--device", "cpu",
                     *out_dir]) == 0
    out = capsys.readouterr().out
    assert "it     2" in out and "drift=" in out
    # a propagator the JAX CLI lacks too is a usage error
    assert app.main(["--prop", "blockdt", "--device", "cpu", *out_dir]) == 2
    assert "unknown --prop 'blockdt'" in capsys.readouterr().err
    # a name that is no case of the JAX package is a usage error
    assert app.main(["--init", "plummer", "--device", "cpu", *out_dir]) == 2
    assert "unknown test case 'plummer'" in capsys.readouterr().err
