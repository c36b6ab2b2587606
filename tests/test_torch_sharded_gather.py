"""The gather backend across ranks (``backend="xla"`` on a mesh) against
the JAX package: gloo ranks on the CPU, P = 2 and 4
(``sphexa_torch.parallel.mesh.spawn``, one torch thread each; one spawn
per P runs every case; both spawns and the CLI start together), the
references computed while the ranks run.
Every case's row count makes the slabs end in partial groups of 64 at
P = 2 and 4, so that a group straddles each slab boundary.

- the search: each rank's lists (``cell_list.search_slab``) as global
  rows, nmask, nc and the global occupancy equal the port's one-device
  ``find_neighbors`` and the JAX function exactly, in each halo mode
  (sparse, windowed, and sparse at margin 1), on Sedov 16 trimmed to
  4,000 rows at ngmax 40 (a periodic box, every row truncated) and on
  4,000 random rows with small h in an open box at ngmax 2 (a level-4
  grid, where the halo is part of the peer slabs); the sized
  NeighborConfig equals the JAX package's ``make_propagator_config(
  backend="xla")`` on the whole state, field for field;
- the fault: ``make_sharded_step`` on an ``xla`` config matches the JAX
  package's ``make_sharded_step`` (its GSPMD program on the conftest's CPU
  devices) on Sedov 10 at ngmax 40, within tests/test_parallel.py's
  tolerances (x rtol 1e-5 atol 1e-7, temp rtol 1e-4, dt rtol 1e-5), h
  within 1e-6; the engine's sharded step of the same state, which sums
  every pair within 2h, differs there by more than 1e-2 of max|vx|;
- steps, each held twice: (a) against the JAX package's one-device
  ``Simulation(backend="xla")`` at tests/test_torch_gather_slice.py's
  tolerances (fields rtol 2e-4, atol 5e-6 x max|.|, temp_lo against
  max|temp|; h rtol 1e-6; dt, the mean neighbour count, the energies and
  egrav rel 1e-6; nc_max, occupancy, the truncated-row count, the limiter,
  the block counts and the gravity high-water marks exact), (b) against
  the port's one-device gather ``Simulation`` with the integer
  diagnostics exact (nc_max, nc_sum, occupancy, the truncated-row count,
  the block counts and bins) and the fields at tests/test_parallel.py's
  tolerances (x rtol 1e-5 atol 1e-7, vx rtol 1e-4 atol 1e-6 x max|vx|,
  temp rtol 1e-4, h rtol 1e-6; dt rel 1e-5): std Sedov at ngmax 40, VE
  Noh with av_clean, VE Evrard with self-gravity (the gather near field
  on the ranks' j-buffers), N-body Evrard, std at dt_bins 4 from a
  Courant-limited start, one step each of turb-ve and std-cooling
  (evrard-cooling, with self-gravity: (a) at tests/test_torch_cooling.py's
  whole-step tolerances, du and du_m1 within 2 float32 ulp of max u over
  dt, dt, the energies and egrav rel 1e-4) and one Ewald step on a jittered
  periodic Sedov 10 (the sharded Ewald tolerances: the velocities and the
  last displacements rtol 1e-2, atol 2e-3 x max|.|, egrav rel 1e-4); the
  std case also in the windowed halo mode, equal to the sparse one bit
  for bit; no kernel launch;
- the Simulation: ``Simulation(backend="xla", num_devices=2)`` through
  deferred windows of two steps with the gather halo's margin 0.5: the
  escape sentinel trips, the window rolls back and replays on a regrown
  halo, and lands on the checked run's results (the ledger within 1e-10,
  the fields within x rtol 1e-5, atol 1e-7);
- the CLI: ``--backend xla --devices 2 --device cpu`` on Noh 12: constants.txt
  within 1e-6 relative of the one-device ``--backend xla`` CLI's; the
  part files' derived fields against the one-device gather
  ``compute_output_fields`` of the reassembled state, the port's and the
  JAX package's (rho, p, c rtol 1e-5; u, |v|, r rtol 1e-6:
  tests/test_torch_analysis.py's).
"""

import dataclasses
import functools
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.analysis import compare as jax_compare
from sphexa_tpu.init import init_evrard as jax_init_evrard
from sphexa_tpu.init import init_noh as jax_init_noh
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.init import make_initializer as jax_initializer
from sphexa_tpu.io.snapshot import read_snapshot as jax_read_snapshot
from sphexa_tpu.neighbors import cell_list as jcl
from sphexa_tpu.observables.ledger import ObservableSpec as JaxSpec
from sphexa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sphexa_tpu.parallel.mesh import make_sharded_step as jax_sharded_step
from sphexa_tpu.parallel.mesh import shard_state as jax_shard_state
from sphexa_tpu.sfc import BoundaryType as JBT
from sphexa_tpu.sfc import Box as JBox
from sphexa_tpu.simulation import Simulation as JaxSimulation
from sphexa_tpu.simulation import make_propagator_config as jax_config

from sphexa_torch.analysis import compute_output_fields
from sphexa_torch.app import main as app
from sphexa_torch.convert import state_from_numpy
from sphexa_torch.io import read_snapshot
from sphexa_torch.io.snapshot import list_steps
from sphexa_torch.kernels import sharded_checks as sc
from sphexa_torch.kernels import sharded_gather_checks as sgc
from sphexa_torch.neighbors.cell_list import find_neighbors
from sphexa_torch.parallel.mesh import spawn
from sphexa_torch.propagator import _sort_by_keys
from sphexa_torch.sfc.box import make_global_box
from sphexa_torch.simulation import make_propagator_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT = 300.0
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


def _trim(state, n):
    return jax.tree.map(lambda a: a[:n] if getattr(a, "ndim", 0) == 1 else a, state)


def _random_open(n=4000, seed=11):
    """``n`` uniform rows in an open unit box with h in [0.02, 0.03]: a
    level-4 grid whose windows take part of every peer slab."""
    js, _, jc = jax_init_sedov(16)
    rng = np.random.default_rng(seed)
    js = _trim(js, n)
    pos = rng.uniform(-0.5, 0.5, (3, n)).astype(np.float32)
    h = rng.uniform(0.02, 0.03, n).astype(np.float32)
    js = dataclasses.replace(js, x=jnp.asarray(pos[0]), y=jnp.asarray(pos[1]),
                             z=jnp.asarray(pos[2]), h=jnp.asarray(h))
    return js, JBox.create(-0.5, 0.5, -0.5, 0.5, -0.5, 0.5, boundary=JBT.open), jc


def _periodic_jittered(side=10, seed=7):
    """Periodic Sedov ``side`` with G 0.5, jittered by up to 0.3 of the
    lattice spacing and wrapped into the box."""
    js, jb, jc = jax_init_sedov(side, overrides={"gravConstant": 0.5})
    rng = np.random.default_rng(seed)

    def jitter(a):
        a = np.asarray(a) + rng.uniform(-0.03, 0.03, a.shape).astype(np.float32)
        return jnp.asarray((np.mod(a + 0.5, 1.0) - 0.5).astype(np.float32))

    return dataclasses.replace(js, x=jitter(js.x), y=jitter(js.y), z=jitter(js.z)), jb, jc


#: the searches: (JAX state, box, const), the sizing keywords
SEARCHES = {
    "sedov_truncating": (lambda: (lambda s, b, c: (_trim(s, 4000), b, c))(*jax_init_sedov(16)),
                         {"ngmax": 40}),
    "random_open": (_random_open, {"ngmax": 2, "cell_target": 1}),
}

#: the step runs: (JAX state, box, const), the Simulation keywords, the steps
RUNS = {
    "std_truncating": (lambda: jax_init_sedov(10), {"ngmax": 40}, 2),
    "ve_av_clean": (lambda: jax_init_noh(12), {"prop": "ve", "av_clean": True}, 2),
    "ve_evrard_gravity": (lambda: jax_init_evrard(12), {"prop": "ve"}, 2),
    "nbody": (lambda: jax_init_evrard(12), {"prop": "nbody"}, 2),
    "std_dt_bins": (lambda: jax_init_sedov(10, overrides=COURANT),
                    {"dt_bins": 4, "bin_resort_drift": 0.05}, 3),
    "turb": (lambda: jax_init_sedov(10),
             {"prop": "turb-ve", "turb_settings": {"stMaxModes": 200}}, 1),
    "cooling": (lambda: (lambda s, b, c: (_trim(s, s.n // 4 * 4), b, c))(
        *jax_initializer("evrard-cooling")(12)), {"prop": "std-cooling"}, 1),
    "ewald": (_periodic_jittered, {"prop": "nbody"}, 1),
}
#: the std case again in the windowed halo mode (ranks only: its
#: reference is the sparse mode's run)
WINDOWED = ("std_truncating", {"halo_mode": "windowed"})

FAULT = (lambda: jax_init_sedov(10), 40)


@functools.lru_cache(maxsize=None)
def case_input(table, name):
    make = (SEARCHES if table == "search" else RUNS)[name][0]
    js, jb, jc = make()
    return (js, jb, jc), _flat(js, jb, jc)


def _xla(kw):
    return {"backend": "xla", **kw}


def _runs(P):
    runs = [(case_input("run", n)[1], _xla(kw), steps) for n, (_, kw, steps) in RUNS.items()]
    name, extra = WINDOWED
    _, kw, steps = RUNS[name]
    runs.append((case_input("run", name)[1], _xla({**kw, **extra}), steps))
    if P == 2:
        flat = case_input("run", "std_truncating")[1]
        kw = _xla({"ngmax": 40})
        runs += [(flat, kw, 4), (flat, {**kw, "check_every": 2, "halo_margin": 0.5}, 4)]
    return runs


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """The JAX package's one-device Simulation(backend="xla") of a case:
    each step's scalars and the bins, the final fields."""
    (js, jb, jc), _ = case_input("run", name)
    _, kw, steps = RUNS[name]
    sim = JaxSimulation(js, jb, jc, backend="xla", check_every=1, obs_spec=JaxSpec(), **kw)
    out = []
    for _ in range(steps):
        d = sim.step()
        aux = {"bins": np.asarray(sim._bstate.bins)} if sim._bstate is not None else {}
        out.append(({k: np.asarray(v) for k, v in d.items()}, aux))
    fields = {f.name: np.asarray(getattr(sim.state, f.name))
              for f in dataclasses.fields(sim.state) if np.ndim(getattr(sim.state, f.name)) == 1}
    return out, fields


@functools.lru_cache(maxsize=None)
def port_run(name):
    """The port's one-device gather Simulation of a case."""
    _, flat = case_input("run", name)
    _, kw, steps = RUNS[name]
    return sc.run_props(flat, _xla(kw), steps, "cpu")


@functools.lru_cache(maxsize=None)
def jax_search(name):
    """The whole state's config (JAX, backend "xla"), and the one-device
    searches of the sorted state: the port's and the JAX function's."""
    (js, jb, jc), flat = case_input("search", name)
    _, kw = SEARCHES[name]
    jcfg = jax_config(js, jb, jc, backend="xla", **kw)
    state, box, const = state_from_numpy(*flat, device="cpu")
    cfg = make_propagator_config(state, box, const, backend="xla", **kw)
    gbox = make_global_box(state.x, state.y, state.z, box)
    ss, keys, _ = _sort_by_keys(state, gbox, cfg.curve)
    port = [a.numpy() for a in find_neighbors(ss.x, ss.y, ss.z, ss.h, keys, gbox, cfg.nbr)]
    jbox = JBox(lo=jnp.asarray(gbox.lo.numpy()), hi=jnp.asarray(gbox.hi.numpy()),
                boundaries=tuple(jb.boundaries))
    nbr = {k: v for k, v in dataclasses.asdict(cfg.nbr).items()
           if k in {f.name for f in dataclasses.fields(jcl.NeighborConfig)}}
    want = [np.asarray(a) for a in jcl.find_neighbors(
        *(jnp.asarray(a.numpy()) for a in (ss.x, ss.y, ss.z, ss.h, keys)), jbox,
        jcl.NeighborConfig(**nbr))]
    return jcfg, cfg, port, want


@functools.lru_cache(maxsize=None)
def jax_fault(P):
    """The JAX package's make_sharded_step of the fault case on P of the
    conftest's CPU devices."""
    make, ngmax = FAULT
    js, jb, jc = make()
    jcfg = jax_config(js, jb, jc, backend="xla", ngmax=ngmax)
    mesh = jax_make_mesh(P)
    new, _, d = jax_sharded_step(mesh, jcfg)(jax_shard_state(js, mesh), jb)
    return ({f: np.asarray(getattr(new, f)) for f in ("x", "vx", "h", "temp")},
            float(d["dt"]), int(d["nc_max"]))


def _cli(args, cwd):
    env = {**os.environ, "PYTHONPATH": ROOT}
    return subprocess.run([sys.executable, "-m", "sphexa_torch.app.main", *args,
                           "--device", "cpu", "--quiet"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


CLI_ARGS = ["--init", "noh", "-n", "12", "-s", "2", "-w", "2", "--backend", "xla"]


def _one_device_refs():
    for i, n in enumerate(RUNS):
        port_run(n)
        if i % 2:
            jax_run(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything that runs on ranks, started together: one spawn of P
    ranks per P (``sharded_gather_checks.rank_gather_suite``) and the CLI
    with ``--devices 2`` (a subprocess); meanwhile the JAX and one-device
    references and the one-device CLI in this process. Returns {P: each
    rank's suite, "cli": the CLI runs' directory}."""
    searches = [(case_input("search", n)[1], kw) for n, (_, kw) in SEARCHES.items()]
    fault = (_flat(*FAULT[0]()), FAULT[1])
    base = tmp_path_factory.mktemp("cli")
    with ThreadPoolExecutor(4) as pool:
        jobs = {P: pool.submit(spawn, sgc.rank_gather_suite, P,
                               args=(searches, fault, _runs(P)),
                               workdir=str(tmp_path_factory.mktemp(f"ranks{P}")),
                               device="cpu", threads=1, timeout=JOIN_TIMEOUT)
                for P in (2, 4)}
        cli = pool.submit(_cli, CLI_ARGS + ["--devices", "2", "-o", str(base / "two")], base)
        # the one-device references, half the JAX ones in a second thread
        # (XLA's compiles and torch's ops release the interpreter)
        refs = pool.submit(_one_device_refs)
        for P in (2, 4):
            jax_fault(P)
        for n in SEARCHES:
            jax_search(n)
        for n in list(RUNS)[::2]:
            jax_run(n)
        refs.result()
        assert app.main(CLI_ARGS + ["-o", str(base / "one"), "--device", "cpu",
                                    "--quiet"]) == 0
        out = {P: job.result() for P, job in jobs.items()}
        done = cli.result()
    assert done.returncode == 0, done.stderr
    out["cli"] = base
    return out


@pytest.fixture(scope="module")
def mesh_runs(runs):
    return lambda P: runs[P]


@pytest.fixture(scope="module")
def cli_runs(runs):
    return runs["cli"]


def _cat(res, key):
    return np.concatenate([r["fields"][key] for r in res])


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", list(SEARCHES))
def test_slab_search_matches_one_device_and_jax(P, name, mesh_runs):
    i = list(SEARCHES).index(name)
    res = [r["search"][i] for r in mesh_runs(P)]
    jcfg, cfg, port, want = jax_search(name)
    S = res[0]["S"]
    assert S % 64 != 0  # the slabs end in partial groups
    # the sized config, field for field: the one-device one, the JAX one
    nbr = dataclasses.asdict(cfg.nbr)
    for r in res:
        assert r["nbr"] == nbr
    for k, v in nbr.items():
        assert getattr(jcfg.nbr, k) == v, k
    for a, b in zip(port, want):
        np.testing.assert_array_equal(a, b)
    for mode in sgc.MODES:
        got = {k: np.concatenate([r[mode][k] for r in res]) for k in ("nidx", "nmask", "nc")}
        for label, ref in zip(("nidx", "nmask", "nc"), want):
            np.testing.assert_array_equal(got[label], ref, err_msg=f"{name} P={P} {mode}")
        occ = max(r[mode]["occ"] for r in res)
        ok = all(r[mode]["window_ok"] for r in res)
        assert (occ if ok else cfg.nbr.cap + 1) == int(want[3]), mode
        assert not any(r[mode]["escaped"] for r in res), mode
    if name == "sedov_truncating":
        assert (want[2] > cfg.nbr.ngmax).all()
    if name == "random_open":
        # truncated rows and rows with none; the tight sparse halo ships
        # part of the peer slabs
        assert 0 < int((want[2] > 2).sum()) and int((want[2] == 0).sum()) > 0
        assert all(r["tight"]["served"] < (P - 1) * S for r in res)


# ---------------------------------------------------------------------------
# the fault: make_sharded_step on an xla config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
def test_make_sharded_step_xla_config_runs_the_gather_path(P, mesh_runs):
    out = [r["fault"] for r in mesh_runs(P)]
    want, dt, nc_max = jax_fault(P)

    def cat(backend, f):
        return np.concatenate([o[backend][f] for o in out])

    np.testing.assert_allclose(cat("xla", "x"), want["x"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(cat("xla", "temp"), want["temp"], rtol=1e-4)
    np.testing.assert_allclose(cat("xla", "h"), want["h"], rtol=1e-6)
    d = out[0]["xla"]["diag"]
    assert d["dt"] == pytest.approx(dt, rel=1e-5)
    assert d["nc_max"] == nc_max
    # what an xla config ran before the stages routed on the backend: the
    # engine's sum over every pair within 2h, far from the truncated lists
    vx = np.abs(want["vx"]).max()
    assert np.abs(cat("pallas", "vx") - want["vx"]).max() > 1e-2 * vx
    assert np.abs(cat("xla", "vx") - want["vx"]).max() < 1e-4 * vx


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


#: diagnostics equal to the JAX package's bit for bit, where a step has them
EXACT = ("nc_max", "occupancy", "n_nc_clip", "dt_limiter", "bdt_active", "m2p_max", "p2p_max",
         "leaf_occ")
#: diagnostics equal to the port's one-device step
EXACT_ONE = ("nc_max", "nc_sum", "occupancy", "n_nc_clip", "bdt_active", "bdt_substep",
             "bdt_resort", "bdt_drift")


#: the fields an Ewald step moves by its accelerations (the velocities and
#: the last displacements), held at the sharded Ewald tolerance
EWALD_FIELDS = ("vx", "vy", "vz", "x_m1", "y_m1", "z_m1")


def _fields_vs_jax(res, jfields, name, gravity_order: bool, du_atol=None):
    for f, b in jfields.items():
        a = _cat(res, f)
        if f == "h":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f"{name} h")
            continue
        if du_atol is not None and f in ("du", "du_m1"):
            np.testing.assert_allclose(a, b, rtol=0, atol=du_atol, err_msg=f"{name} {f}")
            continue
        ref = jfields["temp"] if f == "temp_lo" else b
        if gravity_order and f in EWALD_FIELDS:
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=2e-3 * float(np.abs(b).max()),
                                       err_msg=f"{name} {f}")
            continue
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-6 * float(np.abs(ref).max()),
                                   err_msg=f"{name} {f}")


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name", list(RUNS))
def test_steps_match_jax_and_one_device(P, name, mesh_runs):
    out = mesh_runs(P)
    i = list(RUNS).index(name)
    res = [o["runs"][i] for o in out]
    (jsteps, jfields), port = jax_run(name), port_run(name)
    ewald = name == "ewald"
    du_atol = None
    if name == "cooling":
        # tests/test_torch_cooling.py's: the cooling source is a difference
        # of two energies, held to 2 float32 ulp of max u over dt
        cv = case_input("run", name)[0][2].cv
        du_atol = 2.0 * float(np.finfo(np.float32).eps) * cv * float(
            np.abs(jfields["temp"]).max()) / float(jsteps[-1][0]["dt"])
    for it, ((jd, jaux), pstep) in enumerate(zip(jsteps, port["steps"])):
        d = res[0]["steps"][it]["diag"]
        for r in res:
            assert r["steps"][it]["diag"] == d  # replicated
        # (a) the JAX package's one-device gather step
        for k in EXACT:
            if k in jd:
                assert d[k] == float(jd[k]), (name, it, k)
        for k in ("dt", "nc_mean", "obs_etot", "obs_eint", "egrav"):
            rel = 1e-4 if ewald or (du_atol is not None and k != "nc_mean") else 1e-6
            if k in jd:
                assert d[k] == pytest.approx(float(jd[k]), rel=rel), (name, it, k)
        if "bins" in jaux:
            bins = np.concatenate([r["steps"][it]["bdt"]["bins"] for r in res])
            np.testing.assert_array_equal(bins, jaux["bins"])
            np.testing.assert_array_equal(bins, pstep["bdt"]["bins"])
        # (b) the port's one-device gather step
        pd = pstep["diag"]
        for k in EXACT_ONE:
            if k in pd:
                assert d[k] == pd[k], (name, it, k)
        assert d["dt"] == pytest.approx(pd["dt"], rel=1e-5), (name, it)
    _fields_vs_jax(res, jfields, name, ewald, du_atol)
    pf = port["fields"]
    np.testing.assert_allclose(_cat(res, "x"), pf["x"], rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(_cat(res, "temp"), pf["temp"], rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(_cat(res, "h"), pf["h"], rtol=1e-6, err_msg=name)
    vx = _cat(res, "vx")
    for ref in (pf["vx"],) + ((jfields["vx"],) if ewald else ()):
        scale = float(np.abs(ref).max())
        if ewald:
            np.testing.assert_allclose(vx, ref, rtol=1e-2, atol=2e-3 * scale, err_msg=name)
        else:
            np.testing.assert_allclose(vx, ref, rtol=1e-4, atol=1e-6 * scale, err_msg=name)
    for r in res:
        assert r["replays"] == 0, name
        if name not in ("nbody", "ewald"):
            assert r["halo"]["mode"] == "sparse" and r["halo_cells"], name
    if name == "std_truncating":
        assert res[0]["steps"][-1]["diag"]["n_nc_clip"] == pf["x"].shape[0]
    assert not any(o["launches"] for o in out)  # no kernel on this path


@pytest.mark.parametrize("P", [2, 4])
def test_windowed_halo_equals_sparse(P, mesh_runs):
    out = mesh_runs(P)
    i, w = list(RUNS).index(WINDOWED[0]), len(RUNS)
    sparse, windowed = [o["runs"][i] for o in out], [o["runs"][w] for o in out]
    assert windowed[0]["halo"]["mode"] == "windowed" and windowed[0]["halo_window"] > 0
    for f in ("x", "vx", "h", "temp"):
        np.testing.assert_array_equal(_cat(windowed, f), _cat(sparse, f), err_msg=f)
    for a, b in zip(windowed[0]["steps"], sparse[0]["steps"]):
        for k in ("dt", "nc_sum", "occupancy", "n_nc_clip"):
            assert a["diag"][k] == b["diag"][k], k


def test_deferred_rollback_replays_on_ranks(mesh_runs):
    """Deferred windows of two steps with the gather halo's margin 0.5:
    the escape sentinel trips, the window rolls back and replays on a
    regrown halo, and lands on the checked run's results."""
    out = mesh_runs(2)
    k = len(RUNS) + 1
    checked, deferred = [o["runs"][k] for o in out], [o["runs"][k + 1] for o in out]
    assert checked[0]["rollbacks"] == 0 and checked[0]["replays"] == 0
    assert deferred[0]["rollbacks"] >= 1 and deferred[0]["replays"] >= 1
    assert ("reconfigure", None) in deferred[0]["events"]
    rows, ref = deferred[0]["rows"], checked[0]["rows"]
    assert [r["it"] for r in rows] == [r["it"] for r in ref] == [1, 2, 3, 4]
    for a, b in zip(rows, ref):
        for key in ("t", "dt", "etot", "eint"):
            assert abs(a[key] - b[key]) <= 1e-10 * abs(b[key]), (a["it"], key)
    for f in ("x", "vx", "temp"):
        np.testing.assert_allclose(_cat(deferred, f), _cat(checked, f), rtol=1e-5, atol=1e-7,
                                   err_msg=f)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_devices_constants_match_one_device(cli_runs):
    a = np.loadtxt(cli_runs / "one" / "constants.txt", ndmin=2)
    b = np.loadtxt(cli_runs / "two" / "constants.txt", ndmin=2)
    assert a.shape == b.shape and a.shape[0] == 2
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(b[:, 1:], a[:, 1:], rtol=1e-6, atol=1e-12)


def test_cli_devices_parts_carry_the_gather_fields(cli_runs):
    base = cli_runs / "two" / "dump_noh.h5"
    assert not base.exists()
    assert sorted(f for f in os.listdir(cli_runs / "two") if ".part" in f) == [
        "dump_noh.part000of002.h5", "dump_noh.part001of002.h5"]
    for step in list_steps(str(base)):
        state, box, const, extra = read_snapshot(str(base), step=step, device="cpu")
        js, jb, jc, jextra = jax_read_snapshot(str(base), step=step)
        np.testing.assert_array_equal(np.asarray(js.x), state.x.numpy())
        cfg = make_propagator_config(state, box, const, backend="xla")
        want = compute_output_fields(state, box, cfg)
        jwant = jax_compare.compute_output_fields(
            js, jb, jax_config(js, jb, jc, backend="xla"))
        assert jwant.keys() == want.keys()
        for k, v in want.items():
            rtol = 1e-5 if k in ("rho", "p", "c") else 1e-6
            np.testing.assert_allclose(extra[k], v, rtol=rtol, atol=0, err_msg=(step, k))
            np.testing.assert_allclose(extra[k], jwant[k], rtol=rtol, atol=0,
                                       err_msg=(step, k, "JAX"))
            np.testing.assert_array_equal(np.asarray(jextra[k]), extra[k])
