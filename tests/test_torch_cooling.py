"""The port's std-cooling slice against the JAX package's, on the CPU (the
port's plain versions, the JAX package's Pallas kernels in interpret
mode): the CIE model (physics/cooling.py) and the primordial network
(physics/primordial.py) function by function on seeded inputs, one
std-cooling step with self-gravity on Evrard 16 (streaming: the
chemistry sorted with the state), CIE and evolved, from the same input
and on the same tree as ``sphexa_tpu.propagator.step_hydro_std_cooling``,
the chemistry riding the list rebuild's sort on Sedov 16 (list mode)
with the JAX package's permutation exactly, a list-mode Simulation, a
deferred rollback restoring the chemistry, the CLI's constants.txt,
and restart from the JAX package's dump with ``chem_*`` fields.

Tolerances, from the float32 functions' conditioning (PyTorch and XLA
round ``pow``, ``exp`` and ``log10`` apart by an ulp or two; XLA's CPU
code contracts a product and a sum into one fused multiply-add and
flushes subnormal results to zero): the temperature (products only) and
the mean molecular weight rel 1e-6; the table interpolation rel 1e-6 /
atol 1e-6 x max|fp| (a fused multiply-add); the rates, channels,
equilibrium fractions and species cooling rel 1e-5 wherever the value
is above 1e-6 of the function's largest over 10 K - 1e9 K (below it,
exp(-157809 / T) and its kin reach the bottom of float32's range,
where XLA's exp loses digits and flushes to zero); the metal residual
atol 1e-4 x the CIE table's rate (a difference of two rates);
cooling_rate rel 1e-4 (10^x with x near -20: an ulp of x is 4e-6 of
the rate) and the subnormal floor atol 1e-30; the 8 semi-implicit
sub-cycles rel 1e-4 / atol 1e-5 x max|du| (tests/test_cooling.py's
sub-cycle tolerance is 5%); the evolved network's fractions rel 1e-5 /
atol 1e-6 (mass fractions of order 1; tests/test_cooling.py's
conservation 1e-5) and its du atol 1e-5 x max|du|; the cooling time
steps rel 1e-4; a permutation of the chemistry exact. Whole steps carry
tests/test_torch_gravity_slice.py's tolerances (fields rtol 2e-4 / atol
5e-6 x max|.|, h rtol 1e-6, dt and egrav rel 1e-4, integer diagnostics
exact) and dt_cool rel 1e-4, except du and du_cool_min: the cooling
source is (u' - u) / dt, a difference of two energies within 1e-6 of
each other, whose float32 precision is an ulp of u over dt (4% of du at
Evrard's first steps), and XLA's CPU code fuses u = cv temp into that
subtraction unrounded (a quarter ulp: 1% of du); they (and du_m1,
which the integrator sets to du) are held to 2 ulp of max u over dt."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.app import main as jax_app
from sphexa_tpu.init import init_evrard_cooling as jax_init_evrard_cooling
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.io import write_snapshot as jax_write_snapshot
from sphexa_tpu.physics import cooling as jc
from sphexa_tpu.physics import primordial as jp
from sphexa_tpu.propagator import rebuild_pair_lists as jax_rebuild
from sphexa_tpu.propagator import step_hydro_std_cooling as jax_step
from sphexa_tpu.simulation import Simulation as JaxSimulation
from sphexa_tpu.simulation import make_propagator_config as jax_config

from sphexa_torch import io
from sphexa_torch.app import main as app
from sphexa_torch.convert import (
    chemistry_from_numpy, state_from_numpy, state_to_numpy, tree_from_numpy,
)
from sphexa_torch.gravity.traversal import GravityConfig
from sphexa_torch.init import init_evrard_cooling, init_sedov
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.physics import cooling as tc
from sphexa_torch.physics import primordial as tp
from sphexa_torch.propagator import _step_hydro_std_cooling, rebuild_pair_lists
from sphexa_torch.simulation import Simulation, make_propagator_config

INT_DIAGS = ("nc_max", "occupancy", "dt_limiter", "m2p_max", "p2p_max", "leaf_occ", "c_max")
CHEM = ("hi", "hii", "hei", "heii", "heiii", "e", "metal")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def _chem_pair(fields):
    """One seeded chemistry as both packages' ChemistryData."""
    return (jc.ChemistryData(**{k: jnp.asarray(v) for k, v in fields.items()}),
            chemistry_from_numpy(fields, device="cpu"))


def _seeded_chem(n, seed=3, x=0.76, metal=0.0122):
    """Partly ionized fractions that sum to the composition."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    ion_h = rng.uniform(0.0, 1.0, n)
    w = rng.dirichlet((1.0, 1.0, 1.0), n)
    y = 1.0 - x - metal
    hii, heii, heiii = x * ion_h, y * w[:, 1], y * w[:, 2]
    return {"hi": f32(x - hii), "hii": f32(hii), "hei": f32(y * w[:, 0]), "heii": f32(heii),
            "heiii": f32(heiii), "e": f32(hii + heii / 4.0 + heiii / 2.0),
            "metal": f32(np.full(n, metal))}


def _close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def gas():
    """Seeded gas spanning the CIE table and beyond: log-uniform T from
    10 K to 1e9 K as code u (the Evrard-cooling units), densities over
    four decades, and a partly ionized chemistry."""
    rng = np.random.default_rng(11)
    n = 4096
    cfg = jc.CoolingConfig()
    mu = 0.6
    temp = 10.0 ** rng.uniform(1.0, 9.0, n)
    u = np.asarray(temp * jc.KB / ((cfg.gamma - 1.0) * mu * jc.MH) / cfg.u_to_cgs, np.float32)
    rho = np.asarray(10.0 ** rng.uniform(-2.0, 2.0, n), np.float32)
    return dict(u=u, rho=rho, chem=_seeded_chem(n), cfg=cfg, tcfg=tc.CoolingConfig())


# -- the CIE model --------------------------------------------------------------

def test_config_prefactors_match_jax():
    """The float64 host prefactors of the default and of a heated,
    re-united configuration: equal."""
    for kw in ({}, {"heating_rate": 1e-25, "m_code_g": 2e40, "l_code_cm": 3e22}):
        a, b = jc.CoolingConfig(**kw), tc.CoolingConfig(**kw)
        for k in ("t_code_s", "rho_to_cgs", "u_to_cgs", "log_cool_prefac", "heating_code"):
            assert getattr(a, k) == getattr(b, k), k
        assert jp._prefactors(a) == tuple(np.float32(v) for v in tp._prefactors(b))


def test_temperature_and_interp_match_jax(gas):
    """u_to_temp, temp_to_u and the table interpolation (below, inside
    and above the table) rel 1e-6; the mean molecular weight rel 1e-6."""
    jchem, tchem = _chem_pair(gas["chem"])
    mu_j, mu_t = jchem.mean_molecular_weight(), tchem.mean_molecular_weight()
    _close(mu_t, mu_j, 1e-6)
    u = torch.as_tensor(gas["u"])
    temp_j = jc.u_to_temp(jnp.asarray(gas["u"]), mu_j, gas["cfg"])
    temp_t = tc.u_to_temp(u, mu_t, gas["tcfg"])
    _close(temp_t, temp_j, 1e-6)
    _close(tc.temp_to_u(temp_t, mu_t, gas["tcfg"]), jc.temp_to_u(temp_j, mu_j, gas["cfg"]),
           1e-6)
    # log T from 1 to 9 crosses both ends of the table (3.8, 8.5) and its knots
    logt = np.concatenate([np.linspace(1.0, 9.0, 1001, dtype=np.float32),
                           np.asarray(jc._LOGT_TABLE, np.float32)])
    _close(tc._log_lambda_cie(torch.as_tensor(10.0 ** logt.astype(np.float64))
                              .to(torch.float32), gas["tcfg"]),
           jc._log_lambda_cie(jnp.asarray(10.0 ** logt.astype(np.float64), jnp.float32),
                              gas["cfg"]), 1e-6)
    xp, fp = np.asarray([0.0, 1.0, 1.0, 3.0], np.float32), np.asarray([1.0, 2.0, 5.0, -1.0],
                                                                      np.float32)
    x = np.linspace(-1.0, 4.0, 101, dtype=np.float32)
    _close(tc._interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp), -60.0, 7.0),
           jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp), left=-60.0, right=7.0),
           1e-6, 1e-6 * 5.0)


@pytest.mark.parametrize("heating", [0.0, 1e-25])
def test_cie_cooling_matches_jax(gas, heating):
    """cooling_rate rel 1e-4 (atol 1e-30), cooling_timestep rel 1e-4,
    cool_particles (8 semi-implicit sub-cycles) rel 1e-4 / atol 1e-5 x
    max|du| at two dt; eos_cooling rel 1e-6."""
    cfg, tcfg = jc.CoolingConfig(heating_rate=heating), tc.CoolingConfig(heating_rate=heating)
    jchem, tchem = _chem_pair(gas["chem"])
    ju, jr = jnp.asarray(gas["u"]), jnp.asarray(gas["rho"])
    tu, tr = torch.as_tensor(gas["u"]), torch.as_tensor(gas["rho"])
    _close(tc.cooling_rate(tr, tu, tchem, tcfg), jc.cooling_rate(jr, ju, jchem, cfg), 1e-4,
           1e-30)
    _close(tc.cooling_timestep(tr, tu, tchem, tcfg), jc.cooling_timestep(jr, ju, jchem, cfg),
           1e-4)
    for dt in (1e-4, 0.3):
        want = jc.cool_particles(jnp.float32(dt), jr, ju, jchem, cfg)
        _close(tc.cool_particles(torch.tensor(dt), tr, tu, tchem, tcfg), want, 1e-4,
               1e-5 * float(np.abs(np.asarray(want)).max()))
    for a, b in zip(tc.eos_cooling(tr, tu, tchem, tcfg), jc.eos_cooling(jr, ju, jchem, cfg)):
        _close(a, b, 1e-6)


def test_eos_catalog_matches_jax(gas):
    """sph/eos.py: the ideal gas from temperature and from u, and the
    polytrope, rel 1e-6 (products, a pow and a sqrt)."""
    from sphexa_tpu.sph import eos as jeos

    from sphexa_torch.sph import eos as teos

    rho, u = gas["rho"], gas["u"]
    temp = np.asarray(u / np.float32(1e7), np.float32)
    pairs = [(teos.ideal_gas_eos(torch.as_tensor(temp), torch.as_tensor(rho), 0.6, 5.0 / 3.0),
              jeos.ideal_gas_eos(jnp.asarray(temp), jnp.asarray(rho), 0.6, 5.0 / 3.0)),
             (teos.ideal_gas_eos_u(torch.as_tensor(u), torch.as_tensor(rho), 1.4),
              jeos.ideal_gas_eos_u(jnp.asarray(u), jnp.asarray(rho), 1.4)),
             (teos.polytropic_eos(torch.as_tensor(rho)), jeos.polytropic_eos(jnp.asarray(rho)))]
    for got, want in pairs:
        for a, b in zip(got, want):
            _close(a, b, 1e-6)


# -- the primordial network ------------------------------------------------------

def test_rates_and_channels_match_jax(gas):
    """k1-k6, every cooling channel, the equilibrium fractions and the
    species cooling at temperatures from 10 K to 1e9 K, rel 1e-5 above
    1e-6 of each one's largest value; the metal residual atol 1e-4 x the
    CIE table's rate."""
    T = np.asarray(10.0 ** np.linspace(1.0, 9.0, 2001), np.float32)
    jT, tT = jnp.asarray(T), torch.as_tensor(T)

    def close(a, b, msg):
        b = np.asarray(b)
        _close(a, b, 1e-5, 1e-6 * float(np.abs(b).max()), msg=msg)

    for name in ("k1_ci_hi", "k2_rec_hii", "k3_ci_hei", "k4_rec_heii", "k5_ci_heii",
                 "k6_rec_heiii"):
        close(getattr(tp, name)(tT), getattr(jp, name)(jT), name)
    jl, tl = jp.lam24_channels(jT), tp.lam24_channels(tT)
    assert set(jl) == set(tl)
    for k in jl:
        close(tl[k], jl[k], k)
    je, te = jp.equilibrium_fractions(jT, 0.76, 0.24), tp.equilibrium_fractions(tT, 0.76, 0.24)
    for k in je:
        close(te[k], je[k], k)
    close(tp.species_cooling24(tT, te), jp.species_cooling24(jT, je), "species")
    metal = np.full(T.shape, 0.0122, np.float32)
    for x_h in (None, 0.7):
        lam_cie = np.asarray(10.0 ** (jc._log_lambda_cie(jT, gas["cfg"]) + 24.0))
        np.testing.assert_array_less(
            np.abs(tp.metal_cooling24(tT, torch.as_tensor(metal), gas["tcfg"], x_h=x_h).numpy()
                   - np.asarray(jp.metal_cooling24(jT, jnp.asarray(metal), gas["cfg"],
                                                   x_h=x_h))),
            1e-4 * lam_cie + 1e-30)


def _network_cfgs():
    """The JAX tests' fast units (n_H = rho_code, rates fast in code
    time), in both packages."""
    kw = dict(m_code_g=jc.MH * jc.KPC**3, l_code_cm=jc.KPC, substeps=32, evolve_species=True)
    return jc.CoolingConfig(**kw), tc.CoolingConfig(**kw)


def test_network_updates_match_jax(gas):
    """_species_update, 64 sub-cycles of relax_to_equilibrium, and the
    coupled evolve_primordial and its cooling time step at the Evrard
    units and at the fast units: fractions rel 1e-5 / atol 1e-6, du atol
    1e-5 x max|du|, the time step rel 1e-4."""
    jchem, tchem = _chem_pair(gas["chem"])
    ju, jr = jnp.asarray(gas["u"]), jnp.asarray(gas["rho"])
    tu, tr = torch.as_tensor(gas["u"]), torch.as_tensor(gas["rho"])
    T = np.asarray(10.0 ** np.random.default_rng(2).uniform(3.5, 7.5, tu.shape[0]),
                   np.float32)
    jT, tT = jnp.asarray(T), torch.as_tensor(T)
    a = np.asarray(10.0 ** np.random.default_rng(4).uniform(-3.0, 3.0, tu.shape[0]), np.float32)
    x_h, y_he = gas["chem"]["hi"] + gas["chem"]["hii"], (
        gas["chem"]["hei"] + gas["chem"]["heii"] + gas["chem"]["heiii"]) / np.float32(4.0)
    jy = jp._species_update(jp._y_of(jchem), jT, jnp.asarray(a), jnp.asarray(x_h),
                            jnp.asarray(y_he))
    ty = tp._species_update(tp._y_of(tchem), tT, torch.as_tensor(a), torch.as_tensor(x_h),
                            torch.as_tensor(y_he))
    for k in jy:
        _close(ty[k], jy[k], 1e-5, 1e-6, msg=k)
    fast_j, fast_t = _network_cfgs()
    rho1 = np.ones(64, np.float32)
    sub = _seeded_chem(64, seed=9)
    jc64, tc64 = _chem_pair(sub)
    T64 = np.asarray(10.0 ** np.linspace(4.0, 6.0, 64), np.float32)
    rj = jp.relax_to_equilibrium(jnp.asarray(T64), jnp.asarray(rho1), jc64, fast_j,
                                 dt_sub=0.02, steps=64)
    rt = tp.relax_to_equilibrium(torch.as_tensor(T64), torch.as_tensor(rho1), tc64, fast_t,
                                 dt_sub=0.02, steps=64)
    for k in CHEM:
        _close(getattr(rt, k), getattr(rj, k), 1e-5, 1e-6, msg=f"relax {k}")
    for cj, ct in ((gas["cfg"], gas["tcfg"]), _network_cfgs()):
        cj = dataclasses.replace(cj, evolve_species=True)
        ct = dataclasses.replace(ct, evolve_species=True)
        dj, nj = jc.cool_step(jnp.float32(1e-3), jr, ju, jchem, cj)
        dt_, nt = tc.cool_step(torch.tensor(1e-3), tr, tu, tchem, ct)
        _close(dt_, dj, 0.0, 1e-5 * float(np.abs(np.asarray(dj)).max()))
        for k in CHEM:
            _close(getattr(nt, k), getattr(nj, k), 1e-5, 1e-6, msg=f"evolve {k}")
        _close(tc.cool_timestep(tr, tu, tchem, ct), jc.cool_timestep(jr, ju, jchem, cj), 1e-4)


def test_chemistry_fields_both_ways(tmp_path):
    """chem_* datasets: the same names, dtypes and values both ways, and
    ionized() equal to the JAX package's."""
    j, t = jc.ChemistryData.ionized(50), tc.ChemistryData.ionized(50)
    jf, tf_ = jc.chemistry_to_fields(j), tc.chemistry_to_fields(t)
    assert {k: (v.dtype, v.shape) for k, v in jf.items()} == \
        {k: (v.dtype, v.shape) for k, v in tf_.items()}
    for k in jf:
        np.testing.assert_array_equal(tf_[k], jf[k], err_msg=k)
    back = jc.chemistry_from_fields(tc.chemistry_to_fields(_chem_pair(_seeded_chem(50))[1]))
    np.testing.assert_array_equal(np.asarray(back.heii), _seeded_chem(50)["heii"])


# -- whole steps -------------------------------------------------------------------

@pytest.fixture(scope="module")
def evrard16():
    """Evrard-cooling 16 with the JAX Simulation's configuration (pallas
    backend) and gravity tree, the port's configuration carrying the same
    caps on the same tree."""
    js, jb, jcst = jax_init_evrard_cooling(16)
    jsim = JaxSimulation(js, jb, jcst, prop="std", backend="pallas", check_every=1)
    jcfg, jtree = jsim._cfg, jsim._gtree
    ts, tb, tcst = state_from_numpy(*_flat(js, jb, jcst), device="cpu")
    meta = jcfg.grav_meta
    tree, tmeta = tree_from_numpy(
        {f.name: np.asarray(getattr(jtree, f.name)) for f in dataclasses.fields(jtree)},
        {"num_leaves": meta.num_leaves, "num_nodes": meta.num_nodes,
         "level_ranges": meta.level_ranges}, device="cpu")
    gcfg = GravityConfig(**{f.name: getattr(jcfg.gravity, f.name)
                            for f in dataclasses.fields(GravityConfig)})
    tcfg = dataclasses.replace(make_propagator_config(ts, tb, tcst), gravity=gcfg,
                               grav_meta=tmeta)
    return dict(js=js, jb=jb, jc=jcst, jcfg=jcfg, jtree=jtree, tcfg=tcfg, tree=tree)


def _compare_step(td, jd, tn, jn, tb, const, u_max):
    for k in INT_DIAGS:
        assert float(td[k]) == float(jd[k]), k
    assert float(td["nc_mean"]) == pytest.approx(float(jd["nc_mean"]), rel=1e-6)
    for k in ("dt", "egrav", "dt_cool"):
        assert float(td[k]) == pytest.approx(float(jd[k]), rel=1e-4), k
    du_atol = 2.0 * float(np.finfo(np.float32).eps) * u_max / float(jd["dt"])
    assert abs(float(td["du_cool_min"]) - float(jd["du_cool_min"])) <= du_atol
    out, _, _ = state_to_numpy(tn, tb, const)
    for f in dataclasses.fields(jn):
        a, b = out[f.name], np.asarray(getattr(jn, f.name))
        if f.name == "h":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg="h")
            continue
        if f.name in ("du", "du_m1"):
            np.testing.assert_allclose(a, b, rtol=0, atol=du_atol, err_msg=f.name)
            continue
        ref = np.asarray(jn.temp) if f.name == "temp_lo" else b
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-6 * float(np.max(np.abs(ref))),
                                   err_msg=f.name)


@pytest.mark.parametrize("evolve", [False, True])
def test_gravity_cooling_step_matches_jax(evrard16, evolve):
    """One std-cooling step on Evrard 16 with self-gravity (streaming: the
    chemistry, shuffled and seeded so that the sort moves it, sorted with
    the state) from the same input on the same tree: CIE (the fractions
    permuted exactly as the JAX package permutes them) and the evolved
    network (rel 1e-5 / atol 1e-6)."""
    c = evrard16
    n = np.asarray(c["js"].x).shape[0]
    jchem, tchem = _chem_pair(_seeded_chem(n, seed=13))
    jcool = jc.CoolingConfig(gamma=c["jc"].gamma, evolve_species=evolve)
    tcool = tc.CoolingConfig(gamma=c["jc"].gamma, evolve_species=evolve)
    ts, tb, tcst = state_from_numpy(*_flat(c["js"], c["jb"], c["jc"]), device="cpu")
    jn, jb, jd, jchem2 = jax_step(c["js"], c["jb"], c["jcfg"], c["jtree"], jchem, jcool)
    tn, tb, td, tchem2 = _step_hydro_std_cooling(ts, tb, c["tcfg"], c["tree"], tchem, tcool)
    u_max = c["jc"].cv * float(np.asarray(c["js"].temp).max())
    _compare_step(td, jd, tn, jn, tb, tcst, u_max)
    assert float(td["egrav"]) < 0.0
    for k in CHEM:
        a, b = getattr(tchem2, k).numpy(), np.asarray(getattr(jchem2, k))
        if evolve and k != "metal":
            _close(a, b, 1e-5, 1e-6, msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


SEDOV_LISTS = {"ng0": 20, "ngmax": 70}


def _shuffled_sedov(side, seed=7):
    """Sedov ``side`` (ng0 20: list mode at side 16) in a shuffled order,
    and a chemistry whose metal fraction is each particle's index."""
    js, jb, jcst = jax_init_sedov(side, SEDOV_LISTS)
    n = np.asarray(js.x).shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    fields, b, const = _flat(js, jb, jcst)
    fields = {k: (v[perm] if np.ndim(v) else v) for k, v in fields.items()}
    chem = _seeded_chem(n, seed=seed)
    chem["metal"] = np.arange(n, dtype=np.float32)
    return fields, b, const, chem, perm


def test_chem_rides_the_list_rebuild_exactly():
    """The list rebuild of a shuffled Sedov 16 (list mode): the port's
    chemistry permuted exactly as the JAX package's, the metal tag
    following each particle's position."""
    fields, b, const, chem, perm = _shuffled_sedov(16)
    ts, tb, tcst = state_from_numpy(fields, b, const, device="cpu")
    js = dataclasses.replace(
        jax_init_sedov(16, SEDOV_LISTS)[0],
        **{k: jnp.asarray(v) for k, v in fields.items()})
    jb = jax_init_sedov(16, SEDOV_LISTS)[1]
    jcfg = jax_config(js, jb, jax_init_sedov(16, SEDOV_LISTS)[2], backend="pallas",
                      use_lists=True)
    tcfg = make_propagator_config(ts, tb, tcst, use_lists=True)
    assert tcfg.list_slot_cap == jcfg.list_slot_cap > 0
    jchem, tchem = _chem_pair(chem)
    jss, _, _, jchem2 = jax_rebuild(js, jb, jcfg, jchem)
    tss, _, _, tchem2 = rebuild_pair_lists(ts, tb, tcfg, aux=tchem)
    np.testing.assert_array_equal(tss.x.numpy(), np.asarray(jss.x))
    for k in CHEM:
        np.testing.assert_array_equal(getattr(tchem2, k).numpy(), np.asarray(getattr(jchem2, k)),
                                      err_msg=k)
    tag = tchem2.metal.numpy().astype(np.int64)
    np.testing.assert_array_equal(tss.x.numpy(), fields["x"][tag])


def test_simulation_cooling_list_mode_keeps_chem_aligned():
    """Simulation(prop="std-cooling") in list mode on the shuffled Sedov
    16, four steps (the first builds the lists): the chemistry stays with
    its particles (the metal tag's particle moved by less than 1e-3 from
    where it started) and the run matches the JAX package's list-mode
    Simulation (fields sorted: x 2e-6, temp 1e-4)."""
    fields, b, const, chem, perm = _shuffled_sedov(16)
    sim = Simulation(*state_from_numpy(fields, b, const, device="cpu"), prop="std-cooling",
                     device="cpu", chem=chemistry_from_numpy(chem, "cpu"),
                     obs_spec=ObservableSpec())
    diags = [sim.step() for _ in range(4)]
    assert sim.lists is not None and all(d["use_lists"] == 1.0 for d in diags)
    assert all("dt_cool" in d and "du_cool_min" in d for d in diags)
    tag = sim.chem.metal.numpy().astype(np.int64)
    np.testing.assert_array_equal(np.sort(tag), np.arange(len(tag)))
    np.testing.assert_allclose(sim.state.x.numpy(), fields["x"][tag], atol=1e-3)
    js = dataclasses.replace(jax_init_sedov(16, SEDOV_LISTS)[0],
                             **{k: jnp.asarray(v) for k, v in fields.items()})
    _, jb, jcst = jax_init_sedov(16, SEDOV_LISTS)
    jsim = JaxSimulation(js, jb, jcst, prop="std-cooling", backend="pallas", use_lists=True,
                         check_every=1, chem=_chem_pair(chem)[0])
    for _ in range(4):
        jsim.step()
    np.testing.assert_array_equal(sim.chem.metal.numpy(), np.asarray(jsim.chem.metal))
    for f, tol in (("x", 2e-6), ("temp", 1e-4)):
        np.testing.assert_allclose(np.sort(getattr(sim.state, f).numpy()),
                                   np.sort(np.asarray(getattr(jsim.state, f))),
                                   rtol=tol, atol=1e-7, err_msg=f)


def test_rollback_restores_the_chemistry():
    """Streaming std-cooling (Sedov 12, evolved network, shuffled), the
    cap forced to 8 before a deferred window of 3: the flush rolls back to
    the window's first carry, chemistry included, and replays; the
    fractions within rel 1e-6 of the checked run's, the metal tag exactly
    where the checked run put it."""
    fields, b, const, chem, _ = _shuffled_sedov(12)
    runs = []
    for ce in (1, 3):
        sim = Simulation(*state_from_numpy(fields, b, const, device="cpu"),
                         prop="std-cooling", device="cpu", use_lists=False, check_every=ce,
                         chem=chemistry_from_numpy(chem, "cpu"),
                         cooling_cfg=tc.CoolingConfig(gamma=const["gamma"],
                                                      evolve_species=True))
        if ce > 1:
            sim._cfg = dataclasses.replace(sim._cfg, nbr=dataclasses.replace(sim._cfg.nbr,
                                                                               cap=8))
        for _ in range(3):
            sim.step()
        runs.append(sim)
    ref, sim = runs
    assert sim.rollbacks == 1 and sim.iteration == 3
    assert torch.equal(sim.chem.metal, ref.chem.metal)
    for k in CHEM[:-1]:
        torch.testing.assert_close(getattr(sim.chem, k), getattr(ref.chem, k), rtol=1e-6,
                                   atol=1e-8)


def _constants(path):
    with open(path) as f:
        head = f.readline()
        return head, np.loadtxt(f, ndmin=2)


@pytest.mark.parametrize("evolve", [False, True])
def test_cli_constants_match_jax(tmp_path, evolve):
    """``--init evrard-cooling -n 12 -s 3 --prop std-cooling
    [--evolve-chem]``: the port's constants.txt against the JAX CLI's
    (the same header, time and dt rel 1e-6, the energies rel 1e-5: float32
    sums over the particles and the gravity solve, in another order)."""
    argv = ["--init", "evrard-cooling", "-n", "12", "-s", "3", "--prop", "std-cooling",
            "--quiet"] + (["--evolve-chem"] if evolve else [])
    assert app.main(argv + ["-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert jax_app.main(argv + ["-o", str(tmp_path / "j")]) == 0
    th, t = _constants(tmp_path / "t" / "constants.txt")
    jh, j = _constants(tmp_path / "j" / "constants.txt")
    assert th == jh and t.shape == j.shape == (3, 7)
    np.testing.assert_array_equal(t[:, 0], j[:, 0])
    np.testing.assert_allclose(t[:, 1:3], j[:, 1:3], rtol=1e-6)
    np.testing.assert_allclose(t[:, 3:], j[:, 3:], rtol=1e-5)


def test_restart_from_jax_dump_with_chemistry(tmp_path):
    """A JAX package's dump of an evolved std-cooling run with its chem_*
    fields: the port reads the chemistry bit for bit, and its CLI restarts
    from it with --evolve-chem, continues the iteration count and writes
    the chem_* fields in the JAX package's names and dtypes."""
    js, jb, jcst = jax_init_evrard_cooling(10)
    jsim = JaxSimulation(js, jb, jcst, prop="std-cooling", check_every=1,
                         cooling_cfg=jc.CoolingConfig(gamma=jcst.gamma, evolve_species=True))
    jsim.step()
    path = str(tmp_path / "jax_dump.h5")
    jax_write_snapshot(path, jsim.state, jsim.box, jcst, iteration=1,
                       extra_fields=jc.chemistry_to_fields(jsim.chem), case="evrard-cooling")
    _, _, _, extra = io.read_snapshot(path, device="cpu")
    chem = tc.chemistry_from_fields(extra)
    for k in CHEM:
        np.testing.assert_array_equal(getattr(chem, k).numpy(), np.asarray(getattr(jsim.chem, k)))
    out = tmp_path / "out"
    assert app.main(["--init", f"{path}:0", "-s", "3", "--prop", "std-cooling", "--evolve-chem",
                     "-w", "3", "-o", str(out), "--device", "cpu", "--quiet"]) == 0
    dump = out / "dump_evrard_cooling.h5"
    fields, attrs = io.snapshot._read_raw(str(dump), -1)
    assert int(attrs["iteration"]) == 3
    for k in CHEM:
        assert fields[f"chem_{k}"].dtype == np.float32 and fields[f"chem_{k}"].shape == (
            np.asarray(jsim.state.x).shape[0],)
    np.testing.assert_array_equal(np.sort(fields["chem_metal"]), np.sort(extra["chem_metal"]))
    rows = _constants(out / "constants.txt")[1]
    assert list(rows[:, 0]) == [2, 3]
