"""The port's turb-ve slice against the JAX package's, on the CPU (the
port's plain versions, the JAX package's Pallas kernels in interpret
mode): the JAX random stream (sph/threefry.py), the stirring's mode
tables, OU update, projection and accelerations (sph/hydro_turb.py),
three list-mode ``_step_turb_ve`` steps and an av_clean one from the
same input as ``sphexa_tpu.propagator.step_turb_ve``, the list-mode
``Simulation(prop="turb-ve")``, the dump fields read by the other
package, the CLI's constants.txt, and a deferred window's rollback
redrawing the same noise.

Tolerances: the key chain, ``random_bits`` and ``uniform`` bit for bit;
``normal`` within 4 ulp (XLA's float32 log1p is its own approximation;
over 400,000 draws the port differs on about 1% by at most 3 ulp); the
mode tables (float64 numpy in both packages, then float32) exact; the
OU phases atol 5e-5 x max|phase| (the damping f = exp(-dt/ts) lies
within 1e-4 of 1, so an ulp of f, where XLA's exp and PyTorch's round
apart, moves sqrt(1 - f^2), the noise term's weight, by about 5e-4 of
itself: 1e-5 of the phases); the stirring
accelerations atol 2e-5 x max|a| (two (N, M) @ (M, 3) products, summed
in another order, of cosines whose arguments reach 6 pi: 1e-6 of the
phase in float32). Whole steps carry the VE slice's tolerance
(tests/test_torch_ve_slice.py): fields rtol 2e-4 / atol 5e-6 x max|.|, h
rtol 1e-6, dt and the mean neighbour count rel 1e-6, integer
diagnostics exact. The turbulence case is run at side 16 with ng0 20
(ngmax 70): at ng0 100 the grid of a periodic box below side 24 is in
fold mode, which has no lists."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.app import main as jax_app
from sphexa_tpu.init import init_turbulence as jax_init_turbulence
from sphexa_tpu.propagator import rebuild_pair_lists as jax_rebuild
from sphexa_tpu.propagator import step_turb_ve as jax_step
from sphexa_tpu.simulation import Simulation as JaxSimulation
from sphexa_tpu.simulation import make_propagator_config as jax_config
from sphexa_tpu.sph import hydro_turb as jht

from sphexa_torch.app import main as app
from sphexa_torch.convert import state_from_numpy, state_to_numpy, turbulence_from_numpy
from sphexa_torch.init import init_turbulence
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.propagator import _step_turb_ve, rebuild_pair_lists
from sphexa_torch.simulation import Simulation, make_propagator_config
from sphexa_torch.sph import hydro_turb as ht
from sphexa_torch.sph import threefry as tf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


#: the list-mode turbulence case: side 16 with fewer neighbours
SIDE, LIST_SETTINGS = 16, {"ng0": 20, "ngmax": 70}


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def _turb(jstate, jcfg):
    """The JAX package's (TurbulenceState, TurbulenceConfig) as the port's."""
    return turbulence_from_numpy(
        {k: np.asarray(getattr(jstate, k)) for k in ("modes", "amplitudes", "phases", "key")},
        dataclasses.asdict(jcfg), device="cpu")


def _ulp(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


# -- the random stream ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 42, 251299, 2**31 - 1, -7])
def test_key_chain_and_bits_match_jax(seed):
    """PRNGKey, split (2 and 5 ways, three deep) and random_bits at the
    stirring's (112, 3, 2) draw and other shapes, bit for bit; uniform too."""
    jk, tk = jax.random.PRNGKey(seed), tf.prng_key(seed)
    for _ in range(3):
        np.testing.assert_array_equal(tk, np.asarray(jk))
        np.testing.assert_array_equal(tf.split(tk, 5), np.asarray(jax.random.split(jk, 5)))
        for shape in ((112, 3, 2), (1,), (7,), (3, 5), (1001,)):
            np.testing.assert_array_equal(
                tf.random_bits(tk, shape), np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
            np.testing.assert_array_equal(
                tf.uniform(tk, shape, -0.5, 2.0),
                np.asarray(jax.random.uniform(jk, shape, jnp.float32, -0.5, 2.0)))
        jk, _ = jax.random.split(jk)
        tk, _ = tf.split(tk)


def test_normal_within_ulp():
    """jax.random.normal in float32, within 4 ulp on 20 keys x 10,000."""
    worst = 0
    for seed in range(20):
        k = jax.random.PRNGKey(seed)
        worst = max(worst, _ulp(tf.normal(tf.prng_key(seed), (10_000,)),
                                jax.random.normal(k, (10_000,), jnp.float32)))
    assert worst <= 4
    x = np.asarray([-1.0, 1.0, 0.0], np.float32)
    np.testing.assert_array_equal(tf.erf_inv(x), np.asarray(jax.lax.erf_inv(jnp.asarray(x))))


# -- the stirring ------------------------------------------------------------

@pytest.mark.parametrize("spect_form", [0, 1, 2])
def test_mode_tables_match_jax(spect_form):
    """create_stirring_modes: the mode table, amplitudes and config exact,
    the key bit for bit, the initial phases within 4 ulp of the draw."""
    jcfg, js = jht.create_stirring_modes(1.0, spect_form=spect_form)
    tcfg, ts = ht.create_stirring_modes(1.0, spect_form=spect_form)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(ts.modes.numpy(), np.asarray(js.modes))
    np.testing.assert_array_equal(ts.amplitudes.numpy(), np.asarray(js.amplitudes))
    np.testing.assert_array_equal(ts.key, np.asarray(js.key))
    assert ts.phases.shape == (tcfg.num_modes, 3, 2)
    assert _ulp(ts.phases.numpy(), js.phases) <= 4
    if spect_form == 1:
        assert tcfg.num_modes == 112
        np.testing.assert_array_equal(ts.key, [120408355, 694572290])


def test_turb_settings_select_the_table():
    """Simulation(prop="turb-ve", turb_settings=...) builds the JAX
    package's table for those settings (the power-law spectrum here), and
    a step with it stays finite."""
    jcfg, js = jht.create_stirring_modes(1.0, spect_form=2, sol_weight=0.3)
    sim = Simulation(*init_turbulence(8, device="cpu"), prop="turb-ve", device="cpu",
                     turb_settings={"stSpectForm": 2, "solWeight": 0.3})
    assert dataclasses.asdict(sim.turb_cfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(sim.turb_state.modes.numpy(), np.asarray(js.modes))
    sim.step()
    assert bool(torch.isfinite(sim.state.vx).all())


@pytest.fixture(scope="module")
def stirring():
    """The parabolic table, its JAX state and the port's copy of it, and
    seeded positions in the unit box."""
    jcfg, js = jht.create_stirring_modes(1.0)
    ts, tcfg = _turb(js, jcfg)
    rng = np.random.default_rng(5)
    pos = rng.uniform(-0.5, 0.5, (3, 2000)).astype(np.float32)
    return jcfg, js, tcfg, ts, pos


def _phases_close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=5e-5 * float(np.abs(b).max()))


def test_update_noise_matches_jax(stirring):
    """Three OU updates: the key bit for bit, the phases atol 5e-5 x max."""
    jcfg, js, tcfg, ts, _ = stirring
    for dt in (1e-4, 3e-3, 0.05):
        js = jht.update_noise(js, jnp.float32(dt), jcfg)
        ts = ht.update_noise(ts, torch.tensor(dt, dtype=torch.float32), tcfg)
        np.testing.assert_array_equal(ts.key, np.asarray(js.key))
        _phases_close(ts.phases.numpy(), js.phases)


def test_compute_phases_and_accel_match_jax(stirring):
    """The Helmholtz projection (rtol 1e-6) and the stirring accelerations
    (atol 2e-5 x max|a|) from the same phases."""
    jcfg, js, tcfg, ts, pos = stirring
    jpr, jpi = jht.compute_phases(js, jcfg)
    tpr, tpi = ht.compute_phases(ts, tcfg)
    for a, b in ((tpr, jpr), (tpi, jpi)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    ja = jht.st_calc_accel(*(jnp.asarray(p) for p in pos), js, jcfg, jpr, jpi)
    ta = ht.st_calc_accel(*(torch.as_tensor(p) for p in pos), ts, tcfg, tpr, tpi)
    scale = max(float(np.abs(np.asarray(a)).max()) for a in ja)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5 * scale)


def test_drive_turbulence_matches_jax(stirring):
    """drive_turbulence: the accelerations added, the state advanced."""
    jcfg, js, tcfg, ts, pos = stirring
    acc = np.random.default_rng(6).normal(size=(3, pos.shape[1])).astype(np.float32)
    jout = jht.drive_turbulence(*(jnp.asarray(p) for p in pos), *(jnp.asarray(a) for a in acc),
                                jnp.float32(2e-3), js, jcfg)
    tout = ht.drive_turbulence(*(torch.as_tensor(p) for p in pos),
                               *(torch.as_tensor(a) for a in acc),
                               torch.tensor(2e-3, dtype=torch.float32), ts, tcfg)
    scale = max(float(np.abs(np.asarray(a)).max()) for a in jout[:3])
    for a, b in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5 * scale)
    np.testing.assert_array_equal(tout[3].key, np.asarray(jout[3].key))
    _phases_close(tout[3].phases.numpy(), jout[3].phases)


def test_dump_fields_both_ways(stirring, tmp_path):
    """The port's turb_* fields read by the JAX package and the JAX
    package's by the port: the same names, dtypes and values; the port's
    fields go through a dump file and back."""
    from sphexa_torch import io

    jcfg, js, tcfg, ts, _ = stirring
    tfields = ht.turbulence_state_to_fields(ts, tcfg)
    jfields = jht.turbulence_state_to_fields(js, jcfg)
    assert {k: (v.dtype, v.shape) for k, v in tfields.items()} == \
        {k: (v.dtype, v.shape) for k, v in jfields.items()}
    for k in tfields:
        np.testing.assert_array_equal(tfields[k], jfields[k], err_msg=k)
    state, box, const = init_turbulence(4, device="cpu")
    path = str(tmp_path / "dump.npz")
    io.write_snapshot(path, state, box, const, extra_fields=tfields)
    _, _, _, extra = io.read_snapshot(path, device="cpu")
    back_j, back_jcfg = jht.turbulence_state_from_fields(extra)
    assert back_jcfg == jcfg and np.asarray(back_j.key).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(back_j.phases), tfields["turb_phases"])
    back_t, back_tcfg = ht.turbulence_state_from_fields(jfields)
    assert back_tcfg == tcfg
    np.testing.assert_array_equal(back_t.key, np.asarray(js.key))
    assert torch.equal(back_t.phases, ts.phases)


# -- whole steps ---------------------------------------------------------------

def _compare_step(it, td, jd, tn, jn, tb, const):
    for k in ("nc_max", "occupancy", "dt_limiter", "list_ok"):
        assert float(td[k]) == float(jd[k]), (it, k)
    for k in ("nc_mean", "dt", "list_slack"):
        assert float(td[k]) == pytest.approx(float(jd[k]), rel=1e-6), (it, k)
    out, _, _ = state_to_numpy(tn, tb, const)
    for f in dataclasses.fields(jn):
        a, b = out[f.name], np.asarray(getattr(jn, f.name))
        if f.name == "h":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f"step {it} h")
            continue
        ref = np.asarray(jn.temp) if f.name == "temp_lo" else b
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-6 * float(np.max(np.abs(ref))),
                                   err_msg=f"step {it} {f.name}")


@pytest.fixture(scope="module")
def turb_lists():
    """Both packages' list-mode configs (av_clean off and on), the frozen
    sorted state and lists of the turbulence case, and its stirring."""
    js, jb, jc = jax_init_turbulence(SIDE, LIST_SETTINGS)
    cfgs = {}
    for av_clean in (False, True):
        jcfg = jax_config(js, jb, jc, backend="pallas", use_lists=True, av_clean=av_clean)
        ts, tb, tc = state_from_numpy(*_flat(js, jb, jc), device="cpu")
        tcfg = dataclasses.replace(make_propagator_config(ts, tb, tc, use_lists=True),
                                   av_clean=av_clean)
        assert tcfg.list_slot_cap == jcfg.list_slot_cap > 0
        cfgs[av_clean] = (jcfg, tcfg)
    jss, jbb, jl, _ = jax_rebuild(js, jb, cfgs[False][0])
    ts, tb, _ = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    tss, _, tl = rebuild_pair_lists(ts, tb, cfgs[False][1])
    np.testing.assert_array_equal(tss.x.numpy(), np.asarray(jss.x))
    jtcfg, jturb = jht.create_stirring_modes(1.0)
    return dict(jss=jss, jbb=jbb, jc=jc, jl=jl, tl=tl, cfgs=cfgs, jturb=jturb, jtcfg=jtcfg)


def _run_steps(c, av_clean, steps):
    jcfg, tcfg = c["cfgs"][av_clean]
    js, jb, jturb = c["jss"], c["jbb"], c["jturb"]
    for it in range(steps):
        ts, tb, tc = state_from_numpy(*_flat(js, jb, c["jc"]), device="cpu")
        tturb, ttcfg = _turb(jturb, c["jtcfg"])
        jn, jb, jd, jturb = jax_step(js, jb, jcfg, None, jturb, c["jtcfg"], lists=c["jl"])
        tn, tb, td, tturb = _step_turb_ve(ts, tb, tcfg, None, tturb, ttcfg, lists=c["tl"])
        _compare_step(it, td, jd, tn, jn, tb, tc)
        np.testing.assert_array_equal(tturb.key, np.asarray(jturb.key))
        _phases_close(tturb.phases.numpy(), jturb.phases)
        js = jn
    return jn


def test_three_list_steps_match_jax(turb_lists):
    """Three steady list-mode turb-ve steps of each package from the same
    input state, lists and stirring state: the stirring moved the gas."""
    jn = _run_steps(turb_lists, False, 3)
    assert float(np.abs(np.asarray(jn.vx)).max()) > 0


def test_av_clean_step_matches_jax(turb_lists):
    """One list-mode turb-ve step with av_clean (--avclean)."""
    _run_steps(turb_lists, True, 1)


def test_simulation_turb_ve_matches_jax():
    """The list-mode Simulation(prop="turb-ve") against the JAX package's
    (pallas, lists, check_every=1), four steps, fields compared
    order-insensitively as tests/test_torch_ve_slice.py does; the
    stirring state's key bit for bit and its phases atol 5e-5 x max."""
    js, jb, jc = jax_init_turbulence(SIDE, LIST_SETTINGS)
    jsim = JaxSimulation(js, jb, jc, prop="turb-ve", backend="pallas", use_lists=True,
                         check_every=1)
    for _ in range(4):
        jsim.step()
    jsim.flush()
    sim = Simulation(*init_turbulence(SIDE, LIST_SETTINGS, device="cpu"), prop="turb-ve",
                     device="cpu", obs_spec=ObservableSpec())
    diags = [sim.step() for _ in range(4)]
    assert sim.lists is not None and jsim._lists is not None
    assert all(d["use_lists"] == 1.0 for d in diags)
    assert dataclasses.asdict(sim.turb_cfg) == dataclasses.asdict(jsim.turb_cfg)
    np.testing.assert_array_equal(sim.turb_state.key, np.asarray(jsim.turb_state.key))
    _phases_close(sim.turb_state.phases.numpy(), jsim.turb_state.phases)
    s0, s1 = jsim.state, sim.state
    assert float(s1.ttot) == pytest.approx(float(s0.ttot), rel=1e-6)
    for f, tol in (("x", 2e-6), ("temp", 1e-4), ("vx", 1e-4), ("alpha", 1e-4)):
        np.testing.assert_allclose(np.sort(getattr(s1, f).numpy()),
                                   np.sort(np.asarray(getattr(s0, f))),
                                   rtol=tol, atol=1e-7, err_msg=f)


def _constants(path):
    with open(path) as f:
        head = f.readline()
        return head, np.loadtxt(f, ndmin=2)


def test_cli_constants_match_jax(tmp_path, capsys):
    """``--init turbulence -n 12 -s 3 --prop turb-ve``: the port's
    constants.txt against the JAX CLI's, the same columns (machRMS
    last), time and dt rel 1e-6, energies and machRMS rel 1e-6 (the
    energies are float32 sums over the particles in another order)."""
    argv = ["--init", "turbulence", "-n", "12", "-s", "3", "--prop", "turb-ve", "--quiet"]
    assert app.main(argv + ["-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert jax_app.main(argv + ["-o", str(tmp_path / "j")]) == 0
    th, t = _constants(tmp_path / "t" / "constants.txt")
    jh, j = _constants(tmp_path / "j" / "constants.txt")
    assert th == jh and th.split()[-1] == "machRMS" and t.shape == j.shape == (3, 8)
    np.testing.assert_array_equal(t[:, 0], j[:, 0])
    np.testing.assert_allclose(t[:, 1:], j[:, 1:], rtol=1e-6, atol=1e-12)


def test_rollback_replays_the_same_noise():
    """Streaming turb-ve (side 12), the cap forced to 8 before a deferred
    window of 4: the flush rolls back to the window's first carry (the
    stirring's key and phases with it), re-sizes and replays. The key
    equals the checked run's bit for bit, the phases and fields within
    rel 1e-6 (tests/test_simulation_async.py's tolerance)."""
    ref = Simulation(*init_turbulence(12, device="cpu"), prop="turb-ve", device="cpu",
                     use_lists=False)
    for _ in range(4):
        ref.step()
    sim = Simulation(*init_turbulence(12, device="cpu"), prop="turb-ve", device="cpu",
                     use_lists=False, check_every=4)
    key0 = sim.turb_state.key.copy()
    sim._cfg = dataclasses.replace(sim._cfg, nbr=dataclasses.replace(sim._cfg.nbr, cap=8))
    for _ in range(4):
        sim.step()
    assert sim.rollbacks == 1 and sim.iteration == 4
    np.testing.assert_array_equal(sim.turb_state.key, ref.turb_state.key)
    assert not np.array_equal(sim.turb_state.key, key0)
    torch.testing.assert_close(sim.turb_state.phases, ref.turb_state.phases, rtol=1e-6,
                               atol=1e-8)
    for f in ("x", "vx", "temp"):
        torch.testing.assert_close(getattr(sim.state, f), getattr(ref.state, f), rtol=1e-6,
                                   atol=1e-7)


def test_restart_contract_and_cli(tmp_path):
    """kernels/aux_checks.turb_restart on the CPU (turbulence 12, the
    card's check at a small size): the dump with the stirring state read
    back bit for bit, the first restarted step within dt rel 1e-6 and x
    1e-7 of the unbroken run's, the key bit for bit at every step, and
    the CLI restarted with --prop turb-ve (rows 3 and 4 within rel 1e-6)."""
    from sphexa_torch.kernels import aux_checks

    r = aux_checks.turb_restart(12, "cpu", str(tmp_path))
    assert r["cli"]["rows"] == [3, 4] and [row["it"] for row in r["rows"]] == [1, 2, 3, 4]
