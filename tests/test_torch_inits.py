"""The port's last three inits and the glass templates against the JAX
package's, on the CPU: the Kelvin-Helmholtz, wind-shock and isobaric-cube
states, boxes and constants bit for bit (also with 'case:settings.json'
overrides and with a glass template installed), the template's read and
tiling bit for bit on a file the JAX package wrote, the relaxation of
``generate_glass_template`` within 1e-5 of the box length, and three std
steps of each case (the first non-cubic periodic boxes and 2-10x density
contrasts the port steps whole) against ``step_hydro_std`` (backend
"pallas", Pallas in interpret mode), each step from the same input.

Step tolerances: tests/test_torch_slice.py's (the accelerations' rtol
1e-4, atol 5e-6 x max|.| carried through the integrator; h rtol 1e-6; dt
and h_max rel 1e-6, rho_max rel 1e-5; nc_max, occupancy and limiter
exact; nc_mean, a float32 mean of the same counts that may round its
sum and division apart by an ulp, rel 1e-6; h, which only the exact
counts move, rtol 1e-6), but temp_lo, the compensated energy sum's residual
below one ulp of temp, within float32 eps x max|temp|: it holds the bits
an ulp of du moves, so its own relative error says nothing (on the
Kelvin-Helmholtz slab one element of 1,650 differs by 6e-4 of itself,
9e-20 absolute, where temp is about 1e-2)."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_isobaric_cube as jax_init_isobaric_cube
from sphexa_tpu.init import init_kelvin_helmholtz as jax_init_kelvin_helmholtz
from sphexa_tpu.init import init_wind_shock as jax_init_wind_shock
from sphexa_tpu.init import glass as jglass
from sphexa_tpu.propagator import step_hydro_std as jax_step
from sphexa_tpu.simulation import make_propagator_config as jax_config

from sphexa_torch.app import main as app
from sphexa_torch.convert import state_from_numpy, state_to_numpy
from sphexa_torch.init import glass, make_initializer
from sphexa_torch.init.isobaric_cube import init_isobaric_cube
from sphexa_torch.init.kelvin_helmholtz import init_kelvin_helmholtz
from sphexa_torch.init.wind_shock import init_wind_shock
from sphexa_torch.observables.factory import WindBubble, make_observable
from sphexa_torch.simulation import Simulation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


#: case -> (port init, JAX init, a settings override that moves the fields)
INITS = {
    "kelvin-helmholtz": (init_kelvin_helmholtz, jax_init_kelvin_helmholtz, {"omega0": 0.02}),
    "wind-shock": (init_wind_shock, jax_init_wind_shock, {"rhoInt": 8.0}),
    "isobaric-cube": (init_isobaric_cube, jax_init_isobaric_cube, {"rhoInt": 4.0}),
}


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def _assert_same_case(port, jax_case):
    """The port's (state, box, const) bit for bit the JAX package's."""
    fields, box, const = state_to_numpy(*port)
    jf, jb, jc = _flat(*jax_case)
    assert set(fields) == set(jf)
    for k, v in fields.items():
        np.testing.assert_array_equal(v, jf[k], err_msg=k)
        assert v.dtype == jf[k].dtype, k
    np.testing.assert_array_equal(box["lo"], jb["lo"])
    np.testing.assert_array_equal(box["hi"], jb["hi"])
    assert box["boundaries"] == jb["boundaries"]
    for k, v in const.items():
        if k in jc:
            assert v == jc[k], k


@pytest.mark.parametrize("case", list(INITS))
@pytest.mark.parametrize("side", [10, 16])
def test_state_box_constants_bitwise(case, side):
    port, jax_fn, _ = INITS[case]
    _assert_same_case(port(side, device="cpu"), jax_fn(side))


@pytest.mark.parametrize("case", list(INITS))
def test_settings_overrides_bitwise(case, tmp_path):
    """'case:settings.json' through make_initializer, against the JAX
    init with the same overrides; the overrides do move the fields."""
    port, jax_fn, over = INITS[case]
    path = tmp_path / "s.json"
    path.write_text(json.dumps(over))
    got = make_initializer(f"{case}:{path}")(12, device="cpu")
    _assert_same_case(got, jax_fn(12, overrides=over))
    plain, _, _ = state_to_numpy(*port(12, device="cpu"))
    moved, _, _ = state_to_numpy(*got)
    assert any(plain[k].shape != moved[k].shape or not np.array_equal(plain[k], moved[k])
               for k in plain)


def test_wind_shock_constants_one_copy():
    """The observable factory reads the init module's settings (one copy
    in the port), with the overrides applied to its thresholds."""
    ob = make_observable("wind-shock", overrides={"rhoInt": 8.0})
    assert isinstance(ob, WindBubble) and ob.rho_bubble == 8.0


@pytest.fixture
def template(tmp_path):
    """A glass template written by the JAX package: a jittered 6^3 block
    in [0.1, 0.9)^3, so that the read's normalization moves it."""
    x, y, z = jglass.jittered_lattice((0.1, 0.1, 0.1), (0.9, 0.9, 0.9), (6, 6, 6), seed=5)
    path = str(tmp_path / "tpl.h5")
    jglass.write_template_block(path, x, y, z)
    yield path
    glass.set_glass_template(None)
    jglass.set_glass_template(None)


def test_template_read_and_tiling_bitwise(template, tmp_path):
    got = glass.read_template_block(template)
    want = jglass.read_template_block(template)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for lo, hi, counts in (((0, 0, 0), (1, 1, 1), (12, 12, 12)),
                           ((0, 0.25, 0), (1, 0.75, 0.0625), (30, 15, 2)),
                           ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5), (8, 9, 10))):
        for a, b in zip(glass.assemble_glass_cuboid(got, lo, hi, counts),
                        jglass.assemble_glass_cuboid(want, lo, hi, counts)):
            np.testing.assert_array_equal(a, b)
    # the port's writer is read back by the JAX package's reader
    path = str(tmp_path / "port.h5")
    glass.write_template_block(path, *got)
    for a, b in zip(jglass.read_template_block(path), glass.read_template_block(path)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(INITS))
def test_cases_with_glass_template_bitwise(case, template):
    """An installed template replaces the jittered lattice in each case,
    in both packages alike."""
    port, jax_fn, _ = INITS[case]
    glass.set_glass_template(template)
    jglass.set_glass_template(template)
    tiled = port(12, device="cpu")
    _assert_same_case(tiled, jax_fn(12))
    glass.set_glass_template(None)
    jglass.set_glass_template(None)
    lattice = port(12, device="cpu")
    _assert_same_case(lattice, jax_fn(12))
    assert tiled[0].n != lattice[0].n or not torch.equal(tiled[0].x, lattice[0].x)


def test_generate_glass_template_matches_jax():
    """The relaxation on the port's Simulation against the JAX package's,
    within 1e-5 of the box length (the template is normalized to the unit
    cube; distances taken across the periodic wrap)."""
    got = glass.generate_glass_template(side=8, relax_steps=8, device="cpu")
    want = jglass.generate_glass_template(side=8, relax_steps=8)
    for a, b in zip(got, want):
        assert a.shape == (512,) and np.all((a >= 0) & (a < 1))
        d = np.abs(a - np.asarray(b))
        assert np.minimum(d, 1.0 - d).max() < 1e-5


def test_cli_glass_flag(template, tmp_path, capsys):
    """--glass installs the template for the init and clears it after; an
    unreadable file is a usage error."""
    out = ["-o", str(tmp_path), "--device", "cpu"]
    assert app.main(["--init", "isobaric-cube", "-n", "12", "-s", "1", "--glass", template,
                     *out]) == 0
    assert "tiling glass template" in capsys.readouterr().out
    assert glass._ACTIVE_TEMPLATE is None
    assert app.main(["--init", "isobaric-cube", "-n", "12", "-s", "1", "--glass",
                     str(tmp_path / "missing.h5"), *out]) == 2
    assert "cannot read glass template" in capsys.readouterr().err


#: case -> side of the three-step comparison (about 1,600-3,200 particles)
STEP_SIDES = {"kelvin-helmholtz": 12, "wind-shock": 8, "isobaric-cube": 12}


@pytest.mark.parametrize("case", list(STEP_SIDES))
def test_three_std_steps_match_jax(case):
    port, jax_fn, _ = INITS[case]
    js, jb, jc = jax_fn(STEP_SIDES[case])
    jcfg = jax_config(js, jb, jc, backend="pallas")
    sim = Simulation(*state_from_numpy(*_flat(js, jb, jc), device="cpu"), device="cpu",
                     use_lists=False)
    assert dataclasses.asdict(sim.cfg.nbr) == {
        k: getattr(jcfg.nbr, k) for k in dataclasses.asdict(sim.cfg.nbr)}
    for it in range(3):
        sim.state, sim.box, _ = state_from_numpy(*_flat(js, jb, jc), device="cpu")
        jn, jb, jd = jax_step(js, jb, jcfg)
        d = sim.step()
        assert sim.replays == 0
        for k in ("nc_max", "occupancy", "dt_limiter"):
            assert d[k] == float(jd[k]), (it, k)
        for k in ("dt", "h_max", "nc_mean"):
            assert d[k] == pytest.approx(float(jd[k]), rel=1e-6), (it, k)
        assert d["rho_max"] == pytest.approx(float(jd["rho_max"]), rel=1e-5)
        out, box, _ = state_to_numpy(sim.state, sim.box, sim.const)
        np.testing.assert_array_equal(box["hi"], np.asarray(jb.hi))
        for f in dataclasses.fields(jn):
            a, b = out[f.name], np.asarray(getattr(jn, f.name))
            if f.name == "h":
                np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f"step {it} h")
                continue
            if f.name == "temp_lo":
                eps_temp = np.finfo(np.float32).eps * float(np.max(np.abs(jn.temp)))
                np.testing.assert_allclose(a, b, rtol=0, atol=eps_temp,
                                           err_msg=f"step {it} temp_lo")
                continue
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-6 * float(np.max(np.abs(b))),
                                       err_msg=f"step {it} {f.name}")
        if sim.reconfigures:
            # the grid outgrew its config: both packages re-size from the
            # same state
            jcfg = jax_config(jn, jb, jc, backend="pallas")
            assert dataclasses.asdict(sim.cfg.nbr) == {
                k: getattr(jcfg.nbr, k) for k in dataclasses.asdict(sim.cfg.nbr)}
            sim.reconfigures = 0
        js = jn
    jax.block_until_ready(js.x)


def test_cli_runs_new_cases(tmp_path, capsys):
    """The three cases through the CLI on the CPU, with their observables'
    columns in constants.txt."""
    for case, side, col in (("kelvin-helmholtz", 12, "khGrowthRate"),
                            ("wind-shock", 8, "survivorFraction"),
                            ("isobaric-cube", 10, None)):
        d = tmp_path / case
        assert app.main(["--init", case, "-n", str(side), "-s", "2", "-o", str(d),
                         "--device", "cpu"]) == 0
        assert "it     2" in capsys.readouterr().out
        header = (d / "constants.txt").read_text().splitlines()[0]
        assert (col in header) if col else header.endswith("egrav")
