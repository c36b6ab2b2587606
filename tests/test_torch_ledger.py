"""The port's science ledger, case observables, observable specs and
constants.txt writer against the JAX package's, on the CPU.

Tolerances: the energies as tests/test_torch_simulation.py's
``test_five_steps_conserved_quantities`` (etot and eint rel 1e-6, ecin
rel 1e-4; the JAX package sums in float32 without x64, the port in
float64), momenta within 1e-5 x their rounding scale (sum m|v| for the
linear, sum m |r| |v| for the angular); counts, minima, the simulated
time and ``dt_limiter`` exact; the case observables (float32 sums in
both packages, in another order) rel 1e-6; the constants.txt files byte
for byte."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.init import CASES
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.observables import extras as jax_extras
from sphexa_tpu.observables import factory as jax_factory
from sphexa_tpu.observables.ledger import ObservableSpec as JaxSpec
from sphexa_tpu.observables.ledger import ledger_diagnostics as jax_ledger
from sphexa_tpu.observables.ledger import make_observable_spec as jax_make_spec
from sphexa_tpu.propagator import _dt_limiter as jax_dt_limiter
from sphexa_tpu.propagator import step_hydro_std as jax_step
from sphexa_tpu.simulation import make_propagator_config as jax_config

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.observables import (
    ConstantsWriter, ObservableSpec, extras, ledger_diagnostics, make_observable,
    make_observable_spec,
)
from sphexa_torch.propagator import _dt_limiter

#: every case name of the JAX package's CLI, and the wind case with overrides
SPEC_CASES = [(case, None) for case in sorted(CASES)] + [
    ("wind-shock", {"rhoInt": 5.0, "uExt": 3.0, "rSphere": 0.03})]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


@pytest.fixture(scope="module")
def sedov_stepped():
    """Sedov 12 after one JAX step (pallas, interpret mode), as numpy."""
    js, jb, jc = jax_init_sedov(12)
    js, jb, _ = jax_step(js, jb, jax_config(js, jb, jc, backend="pallas"))
    return _flat(js, jb, jc)


def _force_fields(n, seed, ng0, ngmax):
    """Seeded rho, c and neighbour counts, some at or past ngmax and some
    far off the ng0 target (clip and saturation counts not zero)."""
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.5, 2.0, n).astype(np.float32)
    c = rng.uniform(0.1, 1.0, n).astype(np.float32)
    nc = rng.integers(ng0 // 3, ngmax + 20, n).astype(np.int32)
    return rho, c, nc


def _both(fields, box, const, rho, c, nc, spec_kw, egrav):
    """The JAX and the port ledgers on the same numpy inputs, as floats."""
    import sphexa_tpu.sph.particles as jp
    from sphexa_tpu.sfc.box import Box as JaxBox

    jstate = jp.ParticleState(**{k: jnp.asarray(v) for k, v in fields.items()})
    jbox = JaxBox(lo=jnp.asarray(box["lo"]), hi=jnp.asarray(box["hi"]),
                  boundaries=tuple(box["boundaries"]))
    jconst = jp.SimConstants(**{k: v for k, v in const.items()
                                if k in {f.name for f in dataclasses.fields(jp.SimConstants)}})
    jd = jax_ledger(jstate, jnp.asarray(rho), jnp.asarray(nc), jconst, jconst.ngmax,
                    spec=JaxSpec(**spec_kw), egrav=jnp.float32(egrav), box=jbox,
                    c=jnp.asarray(c))
    ts, tb, tc = state_from_numpy(fields, box, const, device="cpu")
    td = ledger_diagnostics(ts, torch.as_tensor(rho), torch.as_tensor(nc), tc, tc.ngmax,
                            spec=ObservableSpec(**spec_kw),
                            egrav=torch.tensor(egrav, dtype=torch.float32), box=tb,
                            c=torch.as_tensor(c))
    assert set(jd) == set(td)
    return ({k: float(v) for k, v in jd.items()}, {k: float(v) for k, v in td.items()}, ts)


def _check(jd, td, ts):
    for k in ("obs_etot", "obs_eint"):
        assert td[k] == pytest.approx(jd[k], rel=1e-6), k
    assert td["obs_ecin"] == pytest.approx(jd["obs_ecin"], rel=1e-4)
    assert td["obs_egrav"] == jd["obs_egrav"]
    v = torch.sqrt(ts.vx**2 + ts.vy**2 + ts.vz**2)
    r = torch.sqrt(ts.x**2 + ts.y**2 + ts.z**2)
    lin_scale = float(torch.sum(ts.m * v, dtype=torch.float64))
    ang_scale = float(torch.sum(ts.m * r * v, dtype=torch.float64))
    assert abs(td["obs_linmom"] - jd["obs_linmom"]) <= 1e-5 * lin_scale
    assert abs(td["obs_angmom"] - jd["obs_angmom"]) <= 1e-5 * ang_scale
    for k in ("obs_ttot", "n_nc_clip", "n_h_sat", "n_bad_rho", "n_bad_h", "n_bad_du",
              "rho_min", "h_min", "du_max"):
        np.testing.assert_equal(td[k], jd[k], err_msg=k)


@pytest.mark.parametrize("extra", ["", "kh", "mach", "wind"])
def test_ledger_matches_jax_after_a_step(sedov_stepped, extra):
    """Sedov 12 after one JAX step, with seeded force-stage fields, each
    case observable riding along (rel 1e-6)."""
    fields, box, const = sedov_stepped
    n = len(fields["x"])
    rho, c, nc = _force_fields(n, 12, const["ng0"], const["ngmax"])
    spec_kw = {"extra": extra}
    if extra == "wind":
        spec_kw.update(rho_bubble=1.0, temp_wind=float(np.median(fields["temp"])),
                       initial_mass=0.3)
    jd, td, ts = _both(fields, box, const, rho, c, nc, spec_kw, egrav=-0.25)
    _check(jd, td, ts)
    assert td["n_nc_clip"] > 0 and td["n_h_sat"] > 0
    assert td["n_bad_rho"] == td["n_bad_h"] == td["n_bad_du"] == 0
    if extra:
        assert td["obs_extra"] == pytest.approx(jd["obs_extra"], rel=1e-6)


def test_ledger_matches_jax_with_planted_nan():
    """A seeded state with NaN planted in rho, h (two) and du: the counts
    and the minima (NaN where a NaN entered) exactly as the JAX ledger's,
    the energies as before."""
    n = 3000
    rng = np.random.default_rng(7)
    fields = {f: rng.uniform(-1.0, 1.0, n).astype(np.float32)
              for f in ("x", "y", "z", "x_m1", "y_m1", "z_m1", "vx", "vy", "vz", "du",
                        "du_m1", "temp_lo")}
    fields.update(h=rng.uniform(0.01, 0.05, n).astype(np.float32),
                  m=rng.uniform(0.5, 1.5, n).astype(np.float32) / n,
                  temp=rng.uniform(1.0, 2.0, n).astype(np.float32),
                  alpha=np.full(n, 0.5, np.float32))
    fields["temp_lo"] *= np.float32(1e-7)
    fields.update(ttot=np.float32(0.125), min_dt=np.float32(1e-3), min_dt_m1=np.float32(1e-3))
    box = {"lo": np.full(3, -1.0, np.float32), "hi": np.full(3, 1.0, np.float32),
           "boundaries": [1, 1, 1]}
    const = {"ng0": 100, "ngmax": 150, "cv": 1.5, "gamma": 5.0 / 3.0}
    rho, c, nc = _force_fields(n, 8, 100, 150)
    rho[3] = np.nan
    fields["h"][[5, 6]] = np.nan
    fields["du"][7] = np.nan
    jd, td, ts = _both(fields, box, const, rho, c, nc, {}, egrav=0.0)
    _check(jd, td, ts)
    assert (td["n_bad_rho"], td["n_bad_h"], td["n_bad_du"]) == (1, 2, 1)
    assert np.isnan(td["rho_min"]) and np.isnan(td["h_min"]) and np.isnan(td["du_max"])


def test_dt_limiter_matches_jax():
    """The binding dt candidate, ties to the earlier name, on seeded
    candidates (some inactive)."""
    from sphexa_tpu.sph.particles import SimConstants as JaxConst

    from sphexa_torch.sph.particles import SimConstants

    jc, tc = JaxConst(), SimConstants()
    rng = np.random.default_rng(3)
    for trial in range(40):
        vals = rng.choice([1e-4, 2e-4, 3e-4], size=5).astype(np.float32)
        active = rng.random(4) < 0.7
        cands = [None if not a else float(v) for a, v in zip(active, vals[1:])]
        jl = int(jax_dt_limiter(jnp.float32(vals[0]), jc, *cands))
        tl = int(_dt_limiter(torch.tensor(vals[0]), tc,
                             *[None if v is None else torch.tensor(v, dtype=torch.float32)
                               for v in cands]))
        assert tl == jl, (trial, vals, cands)


@pytest.mark.parametrize("name", ["kh_growth_rate", "mach_rms", "wind_bubble_fraction"])
def test_case_observables_match_jax(name):
    """The three case observables on seeded arrays, rel 1e-6."""
    from sphexa_tpu.sfc.box import Box as JaxBox

    from sphexa_torch.sfc.box import Box

    rng = np.random.default_rng(11)
    n = 5000
    a = {k: rng.uniform(0.0, 1.0, n).astype(np.float32)
         for k in ("x", "y", "vx", "vy", "vz", "vol", "c", "rho", "temp", "m")}
    a["c"] += np.float32(0.5)
    if name == "kh_growth_rate":
        jbox = JaxBox(lo=jnp.zeros(3), hi=jnp.asarray([1.0, 1.0, 0.0625]))
        tbox = Box.create(0.0, 1.0, 0.0, 1.0, 0.0, 0.0625)
        args = ("x", "y", "vy", "vol")
        jv = jax_extras.kh_growth_rate(*(jnp.asarray(a[k]) for k in args), jbox)
        tv = extras.kh_growth_rate(*(torch.as_tensor(a[k]) for k in args), tbox)
    elif name == "mach_rms":
        args = ("vx", "vy", "vz", "c")
        jv = jax_extras.mach_rms(*(jnp.asarray(a[k]) for k in args))
        tv = extras.mach_rms(*(torch.as_tensor(a[k]) for k in args))
    else:
        args = ("rho", "temp", "m")
        thr = (0.9, 0.6, 1.7)
        jv = jax_extras.wind_bubble_fraction(*(jnp.asarray(a[k]) for k in args), *thr)
        tv = extras.wind_bubble_fraction(*(torch.as_tensor(a[k]) for k in args), *thr)
    assert float(tv) == pytest.approx(float(jv), rel=1e-6)
    assert 0.0 < abs(float(tv)) < float("inf")


@pytest.mark.parametrize("case,overrides", SPEC_CASES,
                         ids=[c + ("+overrides" if o else "") for c, o in SPEC_CASES])
def test_observable_spec_matches_jax(case, overrides):
    """``make_observable_spec`` and the factory's columns for every case
    name (the wind case's thresholds too)."""
    assert dataclasses.asdict(make_observable_spec(case, overrides)) == \
        dataclasses.asdict(jax_make_spec(case, overrides))
    tob = make_observable(case, overrides)
    job = jax_factory.make_observable(case, overrides)
    assert tob.extra_columns == job.extra_columns and type(tob).__name__ == type(job).__name__


def test_constants_writer_bytes_match_jax(tmp_path):
    """The same rows through both writers (energies only and with an extra
    column): byte-equal files."""
    rng = np.random.default_rng(5)
    for case in ("sedov", "kelvin-helmholtz"):
        obs_t, obs_j = make_observable(case), jax_factory.make_observable(case)
        pt, pj = tmp_path / f"t_{case}.txt", tmp_path / f"j_{case}.txt"
        wt, wj = ConstantsWriter(str(pt), obs_t), jax_factory.ConstantsWriter(str(pj), obs_j)
        ncol = 7 + len(obs_t.extra_columns)
        for it in range(1, 6):
            row = [it] + list(rng.normal(size=ncol - 1) * 10.0 ** rng.integers(-12, 6))
            assert wt.write_row(row) == wj.write_row(row)
        assert pt.read_bytes() == pj.read_bytes()
        assert len(pt.read_text().splitlines()) == 6
