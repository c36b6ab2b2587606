"""turb-ve, N-body and block time steps across ranks, and the CLI's
``--devices`` surface, against the JAX package (tests/test_parallel.py's
sharded turb-ve and N-body tests, tests/test_blockdt.py's sharded bins):
gloo ranks on the CPU, P = 2 and 4 (``sphexa_torch.parallel.mesh.spawn``,
one torch thread each; one spawn per P runs every mesh test's cases), the
references computed while the ranks run.

Each mesh run is held twice on the same numpy input: (a) against the JAX
package's one-device ``Simulation`` at the tolerance the port's
one-device test of that propagator holds it to (a sharded run cannot be
closer to XLA than the one-device port), and (b) against the port's own
one-device ``Simulation`` at the tolerance of the JAX package's mesh
test:

- turb-ve, Sedov 16 with 200 modes: (a) tests/test_torch_turbulence.py's
  whole-step tolerances (fields rtol 2e-4, atol 5e-6 x max|.|; h rtol
  1e-6; dt rel 1e-6; the OU phases atol 5e-5 x max|phase|), (b) vx rtol
  1e-4, atol 1e-6, the phases rtol 1e-6, atol 1e-9, dt rtol 1e-5; the
  threefry key bit for bit in both, on every rank;
- N-body, Evrard 16 (G 1, trimmed to a multiple of 4, 2,160 rows: the
  slabs at P = 2 and 4 end in partial target blocks, which the ranks
  classify as the one-device blocks): (a) tests/test_torch_nbody.py's (fields rtol
  2e-4, atol 5e-6 x max|.|; egrav and dt rel 1e-4), (b) vx rtol 5e-4,
  atol 5e-7, egrav rtol 1e-5;
  Ewald on a jittered periodic Sedov 8 (G 0.5): the sharded Ewald
  solve's tolerances (vx rtol 1e-2, atol 2e-3 x max|vx|; egrav rel 1e-4);
  no SPH halo sized on any rank;
- block time steps at dt_bins 4, std and VE Sedov 8 (two substeps) and
  std Sedov 8 with a Courant-limited start (several bins, due rows; four
  substeps) at bin_resort_drift 0.05: (a) tests/test_torch_blockdt.py's
  (the bins, active counts, populations, inversions and resort decisions
  exactly; dt and the due rows' work rel 1e-6; fields rtol 1e-4, atol
  5e-6 x max|.|, h rtol 1e-6, temp_lo float32 eps x max|temp|), (b) the
  bins, substep and dt_min equal, the active counts, populations, work,
  inversions and resort decisions equal at every substep;
- the folded distributed sort equals one stable argsort of the folded
  keys bit for bit, the bins and global indices riding it, the rows sent
  back to their owners exactly; the 30-bit sort unchanged;
- ``Simulation(num_devices=2)`` through deferred windows with a forced
  rollback (an undersized SPH or gravity serve) and replay: the same
  results as the checked steps (the ledger within 1e-10, the fields
  within x rtol 1e-5, atol 1e-7; the key and the bins equal);
- the CLI's ``--devices 2 --device cpu`` with ``--prop turb-ve``,
  ``--prop nbody`` and ``--dt-bins 4``: constants.txt within 1e-4
  relative of the one-device CLI's; the part files' derived fields, read
  by both packages, against the one-device ``compute_output_fields`` of
  the reassembled state, the port's and the JAX package's (rho, p, c
  rtol 1e-5; u, |v|, r rtol 1e-6: tests/test_torch_analysis.py's);
  ``--ascii`` one file, in global row order, equal to the one-device
  CLI's; ``--duration 0`` stops at the first check boundary with every
  part of the final dump; a turb-ve restart from two parts on one device
  resumes the same key chain.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from sphexa_tpu.analysis import compare as jax_compare
from sphexa_tpu.init import init_evrard as jax_init_evrard
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.io.snapshot import read_snapshot as jax_read_snapshot
from sphexa_tpu.observables.ledger import ObservableSpec as JaxSpec
from sphexa_tpu.simulation import Simulation as JaxSimulation
from sphexa_tpu.simulation import make_propagator_config as jax_config

from sphexa_torch.analysis import compute_output_fields
from sphexa_torch.app import main as app
from sphexa_torch.io import read_snapshot
from sphexa_torch.io.snapshot import list_steps, read_snapshot_full
from sphexa_torch.kernels import sharded_checks as sc
from sphexa_torch.parallel.mesh import spawn
from sphexa_torch.simulation import Simulation, make_propagator_config
from sphexa_torch.sph.blockdt import FOLD_BITS
from sphexa_torch.sph.hydro_turb import turbulence_state_from_fields

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT = 300.0
TURB = {"prop": "turb-ve", "turb_settings": {"stMaxModes": 200}}
#: a Courant-limited start: Sedov's particles spread over several bins
COURANT = {"minDt": 1e-3, "minDt_m1": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def _trim(state, k=4):
    n = state.n // k * k
    return jax.tree.map(lambda a: a[:n] if getattr(a, "ndim", 0) == 1 else a, state)


def _periodic_jittered(seed=7):
    """Periodic Sedov 8 with G 0.5, every coordinate moved by up to a
    quarter of the lattice spacing and wrapped into the box: a lattice's
    forces cancel, a jittered one's do not."""
    js, jb, jc = jax_init_sedov(8, overrides={"gravConstant": 0.5})
    rng = np.random.default_rng(seed)

    def jitter(a):
        a = np.asarray(a) + rng.uniform(-0.03, 0.03, a.shape).astype(np.float32)
        return jax.numpy.asarray((np.mod(a + 0.5, 1.0) - 0.5).astype(np.float32))

    return dataclasses.replace(js, x=jitter(js.x), y=jitter(js.y), z=jitter(js.z)), jb, jc


#: the cases: (JAX state, box, const), the Simulation keywords, the steps
CASES = {
    "turb": (lambda: jax_init_sedov(16), TURB, 2),
    "nbody": (lambda: (lambda s, b, c: (_trim(s), b, c))(*jax_init_evrard(16)),
              {"prop": "nbody"}, 2),
    "ewald": (_periodic_jittered, {"prop": "nbody"}, 1),
    "bdt_std": (lambda: jax_init_sedov(8, overrides=COURANT),
                {"prop": "std", "dt_bins": 4, "bin_resort_drift": 0.05}, 4),
    "bdt_ve": (lambda: jax_init_sedov(8), {"prop": "ve", "dt_bins": 4,
                                           "bin_resort_drift": 0.05}, 2),
}


@functools.lru_cache(maxsize=None)
def case_input(name):
    js, jb, jc = CASES[name][0]()
    return (js, jb, jc), _flat(js, jb, jc)


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """The JAX package's one-device Simulation of a case (Pallas in
    interpret mode, streaming): each step's scalars and aux, the final
    fields."""
    (js, jb, jc), _ = case_input(name)
    _, kw, steps = CASES[name]
    sim = JaxSimulation(js, jb, jc, backend="pallas", use_lists=False, check_every=1,
                        obs_spec=JaxSpec(), **kw)
    out = []
    for _ in range(steps):
        d = sim.step()
        aux = {}
        if sim._bstate is not None:
            aux["bins"] = np.asarray(sim._bstate.bins)
        if sim.turb_state is not None:
            aux["key"] = np.asarray(sim.turb_state.key)
            aux["phases"] = np.asarray(sim.turb_state.phases)
        out.append(({k: np.asarray(v) for k, v in d.items()}, aux))
    fields = {f.name: np.asarray(getattr(sim.state, f.name))
              for f in dataclasses.fields(sim.state) if np.ndim(getattr(sim.state, f.name)) == 1}
    return out, fields


@functools.lru_cache(maxsize=None)
def port_run(name):
    """The port's one-device Simulation of a case (``run_props``)."""
    _, flat = case_input(name)
    _, kw, steps = CASES[name]
    return sc.run_props(flat, kw, steps, "cpu")


@functools.lru_cache(maxsize=None)
def _deferred_runs():
    """Checked and deferred runs of each propagator (the deferred one with
    windows of two steps and an undersized serve: the SPH halo's margin
    0.5, or the gravity serve's 0.02 at caps of 32 rows)."""
    turb12 = _flat(*jax_init_sedov(12))
    bdt12 = _flat(*jax_init_sedov(12, overrides=COURANT))
    nbody = case_input("nbody")[1]
    out = []
    for flat, kw, force in ((turb12, TURB, {"halo_margin": 0.5}),
                            (bdt12, {"prop": "std", "dt_bins": 3}, {"halo_margin": 0.5}),
                            (nbody, {"prop": "nbody", "grav_window": 32},
                             {"grav_margin": 0.02})):
        out += [(flat, kw, 4), (flat, {**kw, "check_every": 2, **force}, 4)]
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One spawn of P ranks per P for every mesh test: the cases' runs, the
    folded sort and (P = 2) the deferred windows; the JAX and one-device
    references computed while the first one runs. Returns a function of
    P: ({case: each rank's run}, each rank's sorts, each rank's deferred
    runs)."""
    done = {}

    def get(P):
        if P not in done:
            runs = [(case_input(n)[1], CASES[n][1], CASES[n][2]) for n in CASES]
            deferred = _deferred_runs() if P == 2 else []
            with ThreadPoolExecutor(1) as pool:
                future = pool.submit(spawn, sc.rank_props_suite, P,
                                     args=(runs + deferred, _sort_cases()),
                                     workdir=str(tmp_path_factory.mktemp(f"ranks{P}")),
                                     device="cpu", threads=1, timeout=JOIN_TIMEOUT)
                for n in CASES:
                    jax_run(n)
                    port_run(n)
                out = future.result()
            k = len(CASES)
            done[P] = ({n: [o["runs"][i] for o in out] for i, n in enumerate(CASES)},
                       [o["sort"] for o in out], [o["runs"][k:] for o in out])
        return done[P]

    return get


def _refs(name):
    return jax_run(name), port_run(name)


def _cat(res, key):
    return np.concatenate([r["fields"][key] for r in res])


def _fields_close(res, want, rtol, atol_rel, name, skip=()):
    for f, b in want.items():
        if f in skip:
            continue
        a = _cat(res, f)
        if f == "h":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f"{name} h")
        elif f == "temp_lo":
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=np.finfo(np.float32).eps
                                       * float(np.abs(want["temp"]).max()),
                                       err_msg=f"{name} temp_lo")
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol_rel * float(np.abs(b).max()),
                                       err_msg=f"{name} {f}")


# ---------------------------------------------------------------------------
# the folded distributed sort
# ---------------------------------------------------------------------------


def _sort_cases(n=1024):
    rng = np.random.default_rng(5)
    out = []
    # heavy ties (32 distinct keys), and keys up to the top bit
    for keys in (rng.integers(0, 32, n).astype(np.int64) << 25,
                 rng.integers(0, 1 << 30, n).astype(np.int64)):
        bins = rng.integers(0, 4, n).astype(np.int32)
        cols = rng.standard_normal((n, 3)).astype(np.float32)
        out.append((keys, bins, cols))
    return out


@pytest.mark.parametrize("P", [2, 4])
def test_folded_sort_matches_one_stable_argsort(P, mesh_runs):
    cases = _sort_cases()
    out = mesh_runs(P)[1]
    S = cases[0][0].shape[0] // P
    for i, (keys, bins, cols) in enumerate(cases):
        folded = (keys << FOLD_BITS) | bins
        order = np.argsort(folded, kind="stable")
        got = {k: np.concatenate([o[i][k] for o in out]) for k in out[0][i]}
        np.testing.assert_array_equal(got["folded"], folded[order])
        np.testing.assert_array_equal(got["bins"], bins[order])
        np.testing.assert_array_equal(got["gidx"], order)
        np.testing.assert_array_equal(got["rows"], cols[order])
        # back to the owners: every rank's rows where they were
        np.testing.assert_array_equal(got["back"], cols)
        sorder = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(got["spatial"], keys[sorder])
        np.testing.assert_array_equal(got["spatial_rows"], cols[sorder])
        assert all(o[i]["rows"].shape[0] == S for o in out)
    # the folded keys used their top bits: a 30-bit select would miss them
    assert int(folded.max()) >= 1 << 31


# ---------------------------------------------------------------------------
# turb-ve, N-body and block time steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
def test_turb_ve_matches_jax_and_one_device(P, mesh_runs):
    res, ((jsteps, jfields), port) = mesh_runs(P)[0]["turb"], _refs("turb")
    for it, ((jd, jaux), pstep) in enumerate(zip(jsteps, port["steps"])):
        steps = [r["steps"][it] for r in res]
        d = steps[0]["diag"]
        for s in steps:
            # the stirring replicated: every rank on the same key and phases
            np.testing.assert_array_equal(s["turb"]["key"], steps[0]["turb"]["key"])
            np.testing.assert_array_equal(s["turb"]["phases"], steps[0]["turb"]["phases"])
            assert s["diag"]["dt"] == d["dt"]
        t = steps[0]["turb"]
        # (a) the JAX package's step
        np.testing.assert_array_equal(t["key"], jaux["key"])
        np.testing.assert_allclose(t["phases"], jaux["phases"], rtol=0,
                                   atol=5e-5 * float(np.abs(jaux["phases"]).max()))
        assert d["dt"] == pytest.approx(float(jd["dt"]), rel=1e-6), it
        for k in ("nc_max", "dt_limiter"):
            assert d[k] == float(jd[k]), (it, k)
        # (b) the port's one-device step
        np.testing.assert_array_equal(t["key"], pstep["turb"]["key"])
        np.testing.assert_allclose(t["phases"], pstep["turb"]["phases"], rtol=1e-6, atol=1e-9)
        assert d["dt"] == pytest.approx(pstep["diag"]["dt"], rel=1e-5), it
        assert d["nc_sum"] == pstep["diag"]["nc_sum"], it
    _fields_close(res, jfields, 2e-4, 5e-6, f"P={P} turb-ve vs JAX")
    np.testing.assert_allclose(_cat(res, "vx"), port["fields"]["vx"], rtol=1e-4, atol=1e-6)
    assert float(np.abs(_cat(res, "vx")).max()) > 0  # the stirring moved the gas


@pytest.mark.parametrize("P", [2, 4])
def test_nbody_matches_jax_and_one_device(P, mesh_runs):
    runs = mesh_runs(P)[0]
    res, ((jsteps, jfields), port) = runs["nbody"], _refs("nbody")
    for it, ((jd, _), pstep) in enumerate(zip(jsteps, port["steps"])):
        d = res[0]["steps"][it]["diag"]
        assert all(r["steps"][it]["diag"]["egrav"] == d["egrav"] for r in res)
        for k in ("dt", "egrav", "obs_etot"):
            assert d[k] == pytest.approx(float(jd[k]), rel=1e-4), (it, k)  # (a)
        assert d["egrav"] == pytest.approx(pstep["diag"]["egrav"], rel=1e-5), it  # (b)
        assert d["dt"] == pytest.approx(pstep["diag"]["dt"], rel=1e-5), it
    _fields_close(res, jfields, 2e-4, 5e-6, f"P={P} nbody vs JAX")
    np.testing.assert_allclose(_cat(res, "vx"), port["fields"]["vx"], rtol=5e-4, atol=5e-7)
    # no SPH halo on any rank: the gravity serve is the one exchange
    for r in res:
        assert r["halo"] == {} and r["halo_cells"] == () and r["halo_window"] == 0
        assert r["grav_halo"]["mode"] == "sparse"
        stages = {s for k, s in r["events"] if k == "exchange"}
        assert stages == {"gravity"}, stages
        assert r["replays"] == 0
    # Ewald: the periodic cube's replica passes on every rank
    res, ((jsteps, jfields), port) = runs["ewald"], _refs("ewald")
    d, jd = res[0]["steps"][0]["diag"], jsteps[0][0]
    for ref in (float(jd["egrav"]), port["steps"][0]["diag"]["egrav"]):
        assert d["egrav"] == pytest.approx(ref, rel=1e-4)
    vx = _cat(res, "vx")
    for ref in (jfields["vx"], port["fields"]["vx"]):
        np.testing.assert_allclose(vx, ref, rtol=1e-2, atol=2e-3 * float(np.abs(ref).max()))


BDT_INT_KEYS = ("bdt_active", "bdt_substep", "bdt_resort", "bdt_drift", "nc_max")


@pytest.mark.parametrize("P", [2, 4])
def test_block_time_steps_match_jax_and_one_device(P, mesh_runs):
    runs = mesh_runs(P)[0]
    for name in ("bdt_std", "bdt_ve"):
        res, ((jsteps, jfields), port) = runs[name], _refs(name)
        for it, ((jd, jaux), pstep) in enumerate(zip(jsteps, port["steps"])):
            d = res[0]["steps"][it]["diag"]
            bins = np.concatenate([r["steps"][it]["bdt"]["bins"] for r in res])
            pop = [d[f"bdt_pop[{k}]"] for k in range(4)]
            # (a) the JAX package's substep
            np.testing.assert_array_equal(bins, jaux["bins"], err_msg=f"{name} {it}")
            for k in BDT_INT_KEYS:
                assert d[k] == float(jd[k]), (name, it, k)
            assert pop == [float(v) for v in jd["bdt_pop"]], (name, it)
            assert d["dt"] == pytest.approx(float(jd["dt"]), rel=1e-6), (name, it)
            assert d["bdt_work"] == pytest.approx(float(jd["bdt_work"]), rel=1e-6), (name, it)
            # (b) the port's one-device substep, exactly
            pb = pstep["bdt"]
            np.testing.assert_array_equal(bins, pb["bins"], err_msg=f"{name} {it}")
            for r in res:
                b = r["steps"][it]["bdt"]
                assert int(b["substep"]) == int(pb["substep"])
                assert np.float32(b["dt_min"]) == np.float32(pb["dt_min"])
            pd = pstep["diag"]
            for k in BDT_INT_KEYS + ("bdt_work",):
                assert d[k] == pd[k], (name, it, k)
            assert pop == [pd[f"bdt_pop[{k}]"] for k in range(4)], (name, it)
            for r in res:
                assert r["steps"][it]["diag"] == d  # replicated
        _fields_close(res, jfields, 1e-4, 5e-6, f"P={P} {name} vs JAX")
        assert res[0]["bdt_counters"] == port["bdt_counters"], name
    drift = runs["bdt_std"][0]["steps"]
    # the Courant-limited start: due rows, several bins, and both decisions
    assert any(s["diag"]["bdt_active"] > 0 for s in drift)
    assert len({s["diag"]["bdt_resort"] for s in drift}) == 2, \
        [(s["diag"]["bdt_resort"], s["diag"]["bdt_drift"]) for s in drift]


def test_deferred_rollback_replays_on_ranks(mesh_runs):
    """Deferred windows of two steps with an undersized serve (SPH halo
    margin 0.5, or the gravity serve's 0.02 at 32-row caps): the escape
    sentinel trips, the window rolls back and is replayed on a regrown
    serve, and lands on the checked run's results."""
    out = mesh_runs(2)[2]
    for i, (_, kw, _) in enumerate(_deferred_runs()[::2]):
        checked = [o[2 * i] for o in out]
        deferred = [o[2 * i + 1] for o in out]
        assert checked[0]["rollbacks"] == 0 and checked[0]["replays"] == 0, kw
        assert deferred[0]["rollbacks"] >= 1 and deferred[0]["replays"] >= 1, kw
        rows, ref = deferred[0]["rows"], checked[0]["rows"]
        assert [r["it"] for r in rows] == [r["it"] for r in ref] == [1, 2, 3, 4]
        for a, b in zip(rows, ref):
            for k in ("t", "dt", "etot", "eint"):
                assert abs(a[k] - b[k]) <= 1e-10 * abs(b[k]), (kw, a["it"], k)
        for f in ("x", "vx", "temp"):
            np.testing.assert_allclose(_cat(deferred, f), _cat(checked, f), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{kw} {f}")
        if "turb" in deferred[0]:
            for d, c in zip(deferred, checked):
                np.testing.assert_array_equal(d["turb"]["key"], c["turb"]["key"])
        if "bdt" in deferred[0]:
            np.testing.assert_array_equal(
                np.concatenate([d["bdt"]["bins"] for d in deferred]),
                np.concatenate([c["bdt"]["bins"] for c in checked]))
            assert deferred[0]["bdt_counters"] == checked[0]["bdt_counters"]


# ---------------------------------------------------------------------------
# the CLI's --devices surface
# ---------------------------------------------------------------------------


def _cli(args, cwd):
    env = {**os.environ, "PYTHONPATH": ROOT}
    return subprocess.run([sys.executable, "-m", "sphexa_torch.app.main", *args,
                           "--device", "cpu", "--quiet"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


#: the CLI runs: (sharded arguments, one-device arguments)
CLI_RUNS = {
    "turb": (["--init", "turbulence", "-n", "12", "-s", "3", "-w", "1", "--prop", "turb-ve"],
             None),
    "nbody": (["--init", "evrard", "-n", "12", "-s", "3", "-w", "5", "--duration", "0",
               "--prop", "nbody"],
              ["--init", "evrard", "-n", "12", "-s", "1", "--prop", "nbody"]),
    "bdt": (["--init", "sedov", "-n", "10", "-s", "2", "-w", "2", "--wextra", "1", "--ascii",
             "--dt-bins", "4"], None),
}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each CLI run with ``--devices 2`` (subprocesses, side by side) and,
    meanwhile, on one device in this process."""
    base = tmp_path_factory.mktemp("cli")
    with ThreadPoolExecutor(len(CLI_RUNS)) as pool:
        jobs = {name: pool.submit(_cli, args + ["--devices", "2", "-o", str(base / f"{name}2")],
                                  base) for name, (args, _) in CLI_RUNS.items()}
        for name, (args, one) in CLI_RUNS.items():
            assert app.main((one or args) + ["-o", str(base / f"{name}1"), "--device", "cpu",
                                             "--quiet"]) == 0, name
        done = {k: f.result() for k, f in jobs.items()}
    for k, p in done.items():
        assert p.returncode == 0, (k, p.stderr)
    return base


def _constants(path):
    return np.loadtxt(path, ndmin=2)


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_cli_devices_constants_match_one_device(cli_runs, name):
    a = _constants(cli_runs / f"{name}1" / "constants.txt")
    b = _constants(cli_runs / f"{name}2" / "constants.txt")
    assert a.shape == b.shape and a.shape[0] == (1 if name == "nbody" else
                                                 int(CLI_RUNS[name][0][5]))
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(b[:, 1:], a[:, 1:], rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("name,pipeline", [("turb", "ve"), ("nbody", "std")])
def test_cli_devices_parts_carry_the_derived_fields(cli_runs, name, pipeline):
    base = cli_runs / f"{name}2" / f"dump_{'turbulence' if name == 'turb' else 'evrard'}.h5"
    assert not base.exists()
    for step in list_steps(str(base)):
        state, box, const, extra = read_snapshot(str(base), step=step, device="cpu")
        js, jb, jc, jextra = jax_read_snapshot(str(base), step=step)
        np.testing.assert_array_equal(np.asarray(js.x), state.x.numpy())
        cfg = make_propagator_config(state, box, const)
        # (b) the port's one-device fields, (a) the JAX package's (Pallas in
        # interpret mode), on the reassembled state
        want = compute_output_fields(state, box, cfg, pipeline=pipeline)
        jwant = jax_compare.compute_output_fields(js, jb, jax_config(js, jb, jc,
                                                                     backend="pallas"),
                                                  pipeline=pipeline)
        assert jwant.keys() == want.keys()
        for k, v in want.items():
            rtol = 1e-5 if k in ("rho", "p", "c") else 1e-6
            np.testing.assert_allclose(extra[k], v, rtol=rtol, atol=0, err_msg=(step, k))
            np.testing.assert_allclose(extra[k], jwant[k], rtol=rtol, atol=0,
                                       err_msg=(step, k, "JAX"))
            np.testing.assert_array_equal(np.asarray(jextra[k]), extra[k])
        assert extra["rho"].shape == (state.n,)


def test_cli_devices_ascii_writes_one_file(cli_runs):
    one, two = cli_runs / "bdt1", cli_runs / "bdt2"
    assert sorted(os.listdir(two)) == sorted(os.listdir(one)) == [
        "constants.txt", "dump_sedov_it1.txt", "dump_sedov_it2.txt"]
    for it in (1, 2):
        a = np.loadtxt(one / f"dump_sedov_it{it}.txt")
        b = np.loadtxt(two / f"dump_sedov_it{it}.txt")
        with open(one / f"dump_sedov_it{it}.txt") as f1, \
                open(two / f"dump_sedov_it{it}.txt") as f2:
            names = f1.readline().split()[1:]
            assert f2.readline().split()[1:] == names
        assert a.shape == b.shape == (1000, len(names))
        for k, name in enumerate(names):
            # the gathered rows in global row order: the state's columns as
            # one device's, the derived ones within the output fields' rtol
            rtol = 1e-5 if name in ("rho", "p", "c") else 0.0
            np.testing.assert_allclose(b[:, k], a[:, k], rtol=rtol, atol=0, err_msg=name)


def test_cli_devices_duration_stops_every_rank(cli_runs):
    out = cli_runs / "nbody2"
    rows = _constants(out / "constants.txt")
    assert rows[:, 0].tolist() == [1.0]
    base = str(out / "dump_evrard.h5")
    parts = sorted(f for f in os.listdir(out) if ".part" in f)
    assert parts == ["dump_evrard.part000of002.h5", "dump_evrard.part001of002.h5"]
    assert list_steps(base) == [0]
    _, _, _, _, attrs = read_snapshot_full(base, device="cpu")
    assert int(attrs["iteration"]) == 1


def test_cli_devices_turb_restart_resumes_the_key_chain(cli_runs):
    """The two-rank run's dumps (iterations 1-3) hold the one-device run's
    key chain; a one-device restart from the parts of iteration 1 draws
    the same keys to iteration 3."""
    two = str(cli_runs / "turb2" / "dump_turbulence.h5")
    one = str(cli_runs / "turb1" / "dump_turbulence.h5")
    assert list_steps(two) == list_steps(one) == [0, 1, 2]
    keys = []
    for step in (0, 1, 2):
        _, _, _, extra = read_snapshot(two, step=step, device="cpu")
        _, _, _, ref = read_snapshot(one, step=step, device="cpu")
        np.testing.assert_array_equal(extra["turb_key"], ref["turb_key"])
        np.testing.assert_allclose(extra["turb_phases"], ref["turb_phases"], rtol=1e-6,
                                   atol=1e-9)
        keys.append(extra["turb_key"])
    state, box, const, extra = read_snapshot(two, step=0, device="cpu")
    turb_state, turb_cfg = turbulence_state_from_fields(extra, device="cpu")
    sim = Simulation(state, box, const, prop="turb-ve", device="cpu", use_lists=False,
                     turb_state=turb_state, turb_cfg=turb_cfg)
    for want in keys[1:]:
        sim.step()
        np.testing.assert_array_equal(np.asarray(sim.turb_state.key, np.uint32), want)
