"""The gather backend through the port's entry points, on the CPU:
``Simulation(backend="xla", device="cpu")`` against the JAX package's
``Simulation(backend="xla")`` over a few steps (std Sedov, VE Noh with
av_clean, VE Evrard with self-gravity through the gather near field and
the sort compaction, std with two dt bins, std at an ngmax below every
row's count), the overflow contract on the search's occupancy, the
output fields, and the CLI's ``--backend``.

Tolerances are tests/test_torch_simulation.py's and
tests/test_torch_ve_slice.py's: per-particle fields rtol 2e-4 / atol
5e-6 x max|.| (temp_lo against max|temp|), h rtol 1e-6, dt, the mean
neighbour count and the energies rel 1e-6, the integer diagnostics
(nc_max, occupancy, the ledger's truncated-row count, the block counts)
exact; the output fields rho, p, c rtol 1e-5 (the density op's); the
CLI's constants.txt rows rel 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

from sphexa_tpu.analysis.compare import compute_output_fields as jax_output_fields
from sphexa_tpu.app import main as jax_app
from sphexa_tpu.init import init_evrard as jax_init_evrard
from sphexa_tpu.init import init_noh as jax_init_noh
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.observables import ObservableSpec as JaxObservableSpec
from sphexa_tpu.simulation import Simulation as JaxSimulation
from sphexa_tpu.simulation import make_propagator_config as jax_config

from sphexa_torch.analysis.compare import output_fields
from sphexa_torch.app import main as app
from sphexa_torch.convert import state_from_numpy
from sphexa_torch.init import init_evrard, init_noh, init_sedov
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.simulation import Simulation, make_propagator_config
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.util.substep_profile import substep_breakdown


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


#: name -> (JAX init, port init, side, steps, Simulation keywords)
RUNS = {
    "std_sedov": (jax_init_sedov, init_sedov, 12, 2, {}),
    "ve_av_clean": (jax_init_noh, init_noh, 12, 2, {"prop": "ve", "av_clean": True}),
    "ve_evrard_gravity": (jax_init_evrard, init_evrard, 12, 2, {"prop": "ve"}),
    "std_dt_bins": (jax_init_sedov, init_sedov, 10, 3, {"dt_bins": 2}),
    "std_truncating": (jax_init_sedov, init_sedov, 12, 2, {"ngmax": 40}),
}

#: diagnostics equal bit for bit, where a step has them
EXACT = ("nc_max", "occupancy", "n_nc_clip", "dt_limiter", "bdt_active", "m2p_max", "p2p_max",
         "leaf_occ")


@pytest.mark.parametrize("name", list(RUNS))
def test_simulation_matches_jax(name):
    """Each package steps its own Simulation on the gather backend from the
    same initial conditions; both sort every step, so the states compare
    row for row."""
    jinit, tinit, side, steps, kw = RUNS[name]
    jsim = JaxSimulation(*jinit(side), backend="xla", check_every=1, obs_spec=JaxObservableSpec(),
                         **kw)
    jd = [jsim.step() for _ in range(steps)]
    pe.reset_launches()
    sim = Simulation(*tinit(side, device="cpu"), device="cpu", backend="xla",
                     obs_spec=ObservableSpec(), **kw)
    td = [sim.step() for _ in range(steps)]
    assert sim.cfg.backend == "xla" and sim.lists is None and sim.replays == 0
    assert sim.cfg.nbr.ngmax == kw.get("ngmax", 150)
    assert not any(pe.LAUNCHES.values())
    for it, (t, j) in enumerate(zip(td, jd)):
        for k in EXACT:
            if k in j:
                assert float(t[k]) == float(j[k]), (it, k)
        for k in ("dt", "nc_mean", "obs_etot", "obs_eint", "egrav"):
            if k in j:
                assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-6), (it, k)
    s0, s1 = jsim.state, sim.state
    for f in dataclasses.fields(s0):
        a, b = getattr(s1, f.name).numpy(), np.asarray(getattr(s0, f.name))
        if f.name == "h":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg="h")
            continue
        ref = np.asarray(s0.temp) if f.name == "temp_lo" else b
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-6 * float(np.max(np.abs(ref))),
                                   err_msg=f.name)
    if name == "ve_evrard_gravity":
        g = sim.cfg.gravity
        assert g.compaction == "sort" and g.super_factor == 0
    if name == "std_truncating":
        # every row keeps 40 of its ~92 neighbours; the ledger counts the
        # rows at the run's ngmax, not the case's 150
        assert td[-1]["n_nc_clip"] == sim.state.n and sim.const.ngmax == 150
        eng = Simulation(*tinit(side, device="cpu"), device="cpu", use_lists=False,
                         obs_spec=ObservableSpec())
        for _ in range(steps):
            eng.step()
        assert float(torch.max(torch.abs(eng.state.vx - sim.state.vx))) > \
            1e-2 * float(torch.max(torch.abs(sim.state.vx)))


@pytest.mark.parametrize("broken", ["cap", "window"])
def test_overflow_resizes_and_replays(broken):
    """On the gather backend the search's occupancy (the densest of all
    window cells, or cap + 1 for a window of one cell) drives the same
    re-size and replay: the step equals a clean run's exactly."""
    ref = Simulation(*init_sedov(12, device="cpu"), device="cpu", cell_target=16,
                     backend="xla", obs_spec=ObservableSpec())
    want = ref.step()
    sim = Simulation(*init_sedov(12, device="cpu"), device="cpu", cell_target=16,
                     backend="xla", obs_spec=ObservableSpec())
    good = sim.cfg
    field = {"cap": 8} if broken == "cap" else {"window": 1}
    sim._cfg = dataclasses.replace(good, nbr=dataclasses.replace(good.nbr, **field))
    got = sim.step()
    assert sim.replays == 1 and sim.reconfigures == 1
    assert dataclasses.asdict(sim.cfg.nbr) == dataclasses.asdict(good.nbr)
    for k in ("dt", "nc_mean", "obs_etot", "rho_max", "occupancy"):
        assert got[k] == want[k], k
    torch.testing.assert_close(sim.state.x, ref.state.x, rtol=0, atol=0)


@pytest.mark.parametrize("pipeline", ["std", "ve"])
def test_output_fields_match_jax(pipeline):
    """The dump's derived fields on the gather backend against the JAX
    package's XLA branch, on the Sedov 10 lattice."""
    js, jb, jc = jax_init_sedov(10)
    jcfg = jax_config(js, jb, jc, backend="xla")
    want = jax_output_fields(js, jb, jcfg, pipeline=pipeline)
    fields = {f.name: np.array(getattr(js, f.name)) for f in dataclasses.fields(js)}
    box = {"lo": np.array(jb.lo), "hi": np.array(jb.hi),
           "boundaries": [int(b) for b in jb.boundaries]}
    ts, tb, tc = state_from_numpy(fields, box, dataclasses.asdict(jc), device="cpu")
    got = output_fields(ts, tb, make_propagator_config(ts, tb, tc, backend="xla"), pipeline)
    for k in ("rho", "p", "c"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, err_msg=k)
    for k in ("r", "u", "vel"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, err_msg=k)


def test_backend_names_and_refusals():
    """"auto" is the engine on every device; unknown names are refused; a
    mesh on the gather backend is not (it asks for the ranks' process
    group: tests/test_torch_sharded_gather.py runs it); the substep split
    is the engine's."""
    state, box, const = init_sedov(8, device="cpu")
    auto = Simulation(state, box, const, device="cpu")
    assert auto.cfg.backend == "pallas" and auto.backend == "pallas"
    gather = Simulation(state, box, const, device="cpu", backend="xla", ngmax=60, block=256)
    assert (gather.cfg.nbr.ngmax, gather.cfg.nbr.block) == (60, 256)
    gather.step()
    assert substep_breakdown(gather) == {}
    with pytest.raises(ValueError, match="unknown backend"):
        Simulation(state, box, const, device="cpu", backend="mosaic")
    with pytest.raises(RuntimeError, match="no process group"):
        Simulation(state, box, const, device="cpu", backend="xla", num_devices=2)


def _constants(path):
    with open(path) as f:
        head = f.readline()
        return head, np.loadtxt(f, ndmin=2)


def test_cli_backend(tmp_path, capsys):
    """``--backend xla`` against the JAX CLI's ``--backend xla`` (time and
    dt rel 1e-6, the energies rel 1e-6); ``--backend pallas`` writes the
    rows of no flag exactly; ``--backend xla --devices 2`` is no usage
    error (tests/test_torch_sharded_gather.py runs it): with
    ``--debug-checks`` it reaches the mesh's own refusal of that flag."""
    argv = ["--init", "noh", "-n", "12", "-s", "3", "--quiet"]
    assert app.main(argv + ["--backend", "xla", "-o", str(tmp_path / "t"),
                            "--device", "cpu"]) == 0
    assert jax_app.main(argv + ["--backend", "xla", "-o", str(tmp_path / "j")]) == 0
    th, t = _constants(tmp_path / "t" / "constants.txt")
    jh, j = _constants(tmp_path / "j" / "constants.txt")
    assert th == jh and t.shape == j.shape == (3, 7)
    np.testing.assert_array_equal(t[:, 0], j[:, 0])
    np.testing.assert_allclose(t[:, 1:], j[:, 1:], rtol=1e-6, atol=1e-12)

    assert app.main(argv + ["--backend", "pallas", "-o", str(tmp_path / "p"),
                            "--device", "cpu"]) == 0
    assert app.main(argv + ["-o", str(tmp_path / "d"), "--device", "cpu"]) == 0
    assert (tmp_path / "p" / "constants.txt").read_text() == \
        (tmp_path / "d" / "constants.txt").read_text()
    capsys.readouterr()
    assert app.main(argv + ["--backend", "xla", "--devices", "2", "--device", "cpu",
                            "--debug-checks", "-o", str(tmp_path / "m")]) == 2
    err = capsys.readouterr().err
    assert "debug_checks is single-device" in err and "--backend xla" not in err
