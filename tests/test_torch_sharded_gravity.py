"""Self-gravity and std-cooling across ranks against the JAX package
(tests/test_parallel.py's sharded gravity, Ewald, spherical, MAC-window
and std-cooling tests): gloo ranks on the CPU, P = 2 and 4, spawned per
test (``sphexa_torch.parallel.mesh.spawn``, one torch thread each), the
JAX references computed while the ranks run.

Exact: the tree built from the ranks' summed key histograms equals the
one-device tree and the JAX package's; every rank's sharded upsweep is
bit-identical; its edges equal the JAX package's; the need matrix, the
MAC-sized caps (open and over the Ewald shifts) and the sampled caps,
the essential set's ``let_cap`` included, equal the JAX package's on the
same multipoles (the JAX package's float32 leaf sums differ from the
port's float64 ones by about 1e-4 in small leaves: ROADMAP Queue 3). One
case's caps are partial (Evrard 20, theta 0.8, P = 4), as
tests/test_parallel.py:735-740 requires.

Within tests/test_parallel.py's tolerances: the sharded upsweep against
the JAX one-device multipoles (test_torch_gravity.py's float32 bounds);
the open, spherical order 4 and Ewald solves on 512 random particles
(ax rtol 1e-2, atol 2e-3 max|a|; egrav rtol 1e-4: the rank-ordered leaf
sums can flip a node at the MAC margin); one VE step (Evrard 16) and one
std step (Evrard 20, theta 0.8) with self-gravity, the sparse gravity
serve and whole slabs (vx rtol 1e-2, atol 5e-4; egrav rtol 1e-4), every
high-water mark within its cap; one std-cooling step, Sedov 16 and
evrard-cooling 16 (temp rtol 1e-4 atol 1e-7, chem.hi rtol 1e-5 atol 1e-8,
dt rtol 1e-5); the CLI's ``--devices 2`` Evrard run against the
one-device CLI's constants.txt (egrav and etot rel 1e-4).
"""

import dataclasses
import functools
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from itertools import product

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.gravity.ewald import EwaldConfig as JaxEwaldConfig
from sphexa_tpu.gravity.ewald import compute_gravity_ewald as jax_ewald
from sphexa_tpu.gravity.traversal import GravityConfig as JaxGravityConfig
from sphexa_tpu.gravity.traversal import compute_gravity as jax_compute_gravity
from sphexa_tpu.gravity.traversal import compute_multipoles as jax_multipoles
from sphexa_tpu.gravity.traversal import estimate_gravity_caps as jax_estimate
from sphexa_tpu.gravity.tree import build_gravity_tree as jax_build_tree
from sphexa_tpu.gravity.tree import linkage_from_leaves as jax_linkage
from sphexa_tpu.init import init_evrard as jax_init_evrard
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.parallel import sizing as jsizing
from sphexa_tpu.propagator import _sort_by_keys as jax_sort
from sphexa_tpu.sfc.box import BoundaryType as JaxBoundary
from sphexa_tpu.sfc.box import Box as JaxBox
from sphexa_tpu.sfc.box import make_global_box as jax_global_box
from sphexa_tpu.sfc.keys import compute_sfc_keys as jax_keys
from sphexa_tpu.simulation import Simulation as JaxSimulation

from sphexa_torch.gravity import traversal as tt
from sphexa_torch.kernels import sharded_checks as sc
from sphexa_torch.parallel.mesh import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT = 300.0

#: the GravityConfig fields the port shares with the JAX package's
PORT_FIELDS = ("theta", "target_block", "m2p_cap", "p2p_cap", "leaf_cap", "G",
               "multipole_order", "super_factor", "super_cap", "compaction",
               "m2p_cap_margin", "let_cap")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ranks_meanwhile(pool, fn, P, tmp_path, *args):
    return pool.submit(spawn, fn, P, args=args, workdir=str(tmp_path), device="cpu",
                       threads=1, timeout=JOIN_TIMEOUT)


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def _trim(state, k=4):
    """The first multiple-of-``k`` rows (equal slabs at P = 2 and 4)."""
    n = state.n // k * k
    return jax.tree.map(lambda a: a[:n] if getattr(a, "ndim", 0) == 1 else a, state)


def _cfg_fields(jcfg, **kw):
    return {**{k: getattr(jcfg, k) for k in PORT_FIELDS}, **kw}


def _sorted_setup(state, box, bucket):
    """The JAX package's sorted arrays, keys, and leaf array."""
    ss, keys, _ = jax_sort(state, box, "hilbert")
    leaf = np.asarray(jsizing.leaf_array_from_device_keys(keys, bucket_size=bucket))
    setup = {f: np.asarray(getattr(ss, f)) for f in ("x", "y", "z", "m", "h")}
    setup.update(keys=np.asarray(keys, np.int64), leaf=leaf,
                 box={"lo": np.asarray(box.lo), "hi": np.asarray(box.hi),
                      "boundaries": [int(v) for v in box.boundaries]})
    return ss, keys, setup


# ---------------------------------------------------------------------------
# the tree, the upsweep, the sizing and the caps, exactly
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def evrard20():
    """Evrard 20 (4,200 rows), theta 0.8, as tests/test_parallel.py's
    MAC-window tests size it; the JAX package's tree, multipoles, caps."""
    state, box, const = jax_init_evrard(20)
    state = _trim(state)
    gbox = jax_global_box(state.x, state.y, state.z, box)
    ss, keys, setup = _sorted_setup(state, gbox, 64)
    tree, meta = jax_linkage(setup["leaf"])
    mps = jax_multipoles(ss.x, ss.y, ss.z, ss.m, keys, tree, meta)
    jcfg = JaxGravityConfig(theta=0.8, G=1.0, use_pallas=True)
    return state, box, const, gbox, ss, keys, setup, tree, meta, mps, jcfg


@pytest.mark.parametrize("P", [2, 4])
def test_tree_upsweep_sizing_and_caps_match_jax(P, tmp_path):
    state, box, const, gbox, ss, keys, setup, tree, meta, mps, jcfg = evrard20()
    S = state.n // P
    mps_np = tuple(np.asarray(a) for a in mps)
    shells = np.array(list(product((-1, 0, 1), repeat=3)), np.float32)
    shifts = shells * np.asarray(gbox.lengths)[0]
    with ThreadPoolExecutor(1) as pool:
        future = ranks_meanwhile(pool, sc.rank_gravity_sizing, P, tmp_path, setup,
                                 _flat(state, box, const), 0.8,
                                 _cfg_fields(jcfg, m2p_cap_margin=1.3), mps_np, shifts)
        args = (ss.x, ss.y, ss.z, ss.m, keys, gbox, tree, meta)
        need = np.asarray(jsizing.gravity_need_matrix(*args, 0.8, P))
        cells = jsizing.device_gravity_halo(*args, theta=0.8, P=P)
        tight = jsizing.device_gravity_halo(*args, theta=0.8, P=P, margin=1.0, quantum=1)
        cells_ewald = jsizing.device_gravity_halo(*args, theta=0.8, P=P,
                                                  shifts=jnp.asarray(shifts))
        caps = jax_estimate(ss.x, ss.y, ss.z, ss.m, keys, gbox, tree, meta, jcfg,
                            let_shards=P)
        jm4 = [np.asarray(a) for a in jax_multipoles(ss.x, ss.y, ss.z, ss.m, keys, tree, meta,
                                                     order=4)]
        out = future.result()
    for o in out:
        # the tree: the ranks' summed histograms give the one-device tree
        np.testing.assert_array_equal(o["leaf_mesh"], setup["leaf"])
        np.testing.assert_array_equal(o["leaf_one"], setup["leaf"])
        # the upsweep: bit-identical on every rank, the JAX edges exactly
        for order in (0, 4):
            for a, b in zip(o[f"upsweep{order}"], out[0][f"upsweep{order}"]):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(o["upsweep0"][3], mps_np[3])
        # the sizing on the JAX multipoles: exact
        np.testing.assert_array_equal(o["need"], need)
        assert o["cells"] == cells and o["cells_tight"] == tight
        assert o["cells_ewald"] == cells_ewald
        got = o["caps"]
        for k in ("m2p_cap", "p2p_cap", "leaf_cap", "super_cap", "let_cap"):
            assert got[k] == getattr(caps, k), (k, got[k], getattr(caps, k))
    assert caps.let_cap > 0
    if P == 4:
        # the regime check: the MAC-sized serve ships less than whole slabs
        assert sum(cells) < (P - 1) * S, (cells, S)
    # the node arrays within float32 tolerance of the JAX one-device pass
    nm, com, q, _ = out[0]["upsweep0"]
    jm, jc, jq = mps_np[:3]
    np.testing.assert_allclose(nm, jm, atol=2e-4 * float(jm[0]))
    np.testing.assert_allclose(com, jc, atol=2e-4)
    np.testing.assert_allclose(q, jq, atol=2e-3 * float(np.abs(jq).max()))
    c4 = out[0]["upsweep4"][2]
    np.testing.assert_allclose(c4, jm4[2], atol=2e-3 * float(np.abs(jm4[2]).max()))


# ---------------------------------------------------------------------------
# the solves: open, spherical order 4, Ewald, the essential set
# ---------------------------------------------------------------------------

SOLVE_CASES = [
    ("open", {}, "open", "slabs"),
    ("open_sparse_let", {"let_cap": "sized"}, "open", "sparse"),
    ("let_bitmask", {"let_cap": "all", "compaction": "bitmask", "super_factor": 2,
                     "super_cap": 1 << 20}, "open", "slabs"),
    ("spherical4", {"multipole_order": 4}, "open", "sparse"),
    ("ewald", {}, "ewald", "slabs"),
    ("ewald_sparse", {}, "ewald", "sparse"),
]


def _random_setup(periodic, n=512, seed=7):
    """tests/test_parallel.py's _random_setup: 512 uniform particles, the
    tree at bucket 32, caps at theta 0.6 and margin 2."""
    rng = np.random.default_rng(seed)
    x, y, z = rng.uniform(-0.5, 0.5, (3, n)).astype(np.float32)
    m = rng.uniform(0.5, 1.5, n).astype(np.float32)
    bt = JaxBoundary.periodic if periodic else JaxBoundary.open
    box = JaxBox.create(-0.5, 0.5, boundary=bt)
    keys = np.asarray(jax_keys(x, y, z, box))
    order = np.argsort(keys)
    xs, ys, zs, ms = (jnp.asarray(np.asarray(a)[order]) for a in (x, y, z, m))
    skeys = jnp.asarray(keys[order])
    gtree, meta = jax_build_tree(keys[order], bucket_size=32)
    cfg = jax_estimate(xs, ys, zs, ms, skeys, box, gtree, meta,
                       JaxGravityConfig(theta=0.6, bucket_size=32, G=1.0), margin=2.0)
    hs = jnp.full_like(xs, 1e-3)
    leaf = np.asarray(gtree.leaf_keys).astype(np.uint64)
    setup = {"x": np.asarray(xs), "y": np.asarray(ys), "z": np.asarray(zs),
             "m": np.asarray(ms), "h": np.asarray(hs), "keys": keys[order].astype(np.int64),
             "leaf": leaf, "box": {"lo": np.asarray(box.lo), "hi": np.asarray(box.hi),
                                   "boundaries": [int(v) for v in box.boundaries]}}
    return (xs, ys, zs, ms, hs, skeys, box, gtree, meta, cfg), setup


@functools.lru_cache(maxsize=None)
def jax_solves():
    """The JAX package's one-device solves (Pallas in interpret mode):
    open and spherical order 4 on the open setup, Ewald on the periodic."""
    out = {}
    for periodic in (False, True):
        (xs, ys, zs, ms, hs, skeys, box, gtree, meta, cfg), setup = _random_setup(periodic)
        rcfg = dataclasses.replace(cfg, use_pallas=True)
        if periodic:
            ax, _, _, egrav, _ = jax_ewald(xs, ys, zs, ms, hs, skeys, box, gtree, meta, rcfg,
                                           JaxEwaldConfig())
            out["ewald"] = (np.asarray(ax), float(egrav))
        else:
            for name, order in (("open", 0), ("spherical4", 4)):
                ax, _, _, egrav, _ = jax_compute_gravity(
                    xs, ys, zs, ms, hs, skeys, box, gtree, meta,
                    dataclasses.replace(rcfg, multipole_order=order))
                out[name] = (np.asarray(ax), float(egrav))
        out[("setup", periodic)] = (setup, _cfg_fields(cfg, m2p_cap_margin=1.3),
                                    np.asarray(box.lengths))
    return out


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_solves_match_jax(P, tmp_path):
    (_, setup_o), (_, setup_p) = _random_setup(False), _random_setup(True)
    shifts = np.array(list(product((-1, 0, 1), repeat=3)), np.float32) * 1.0
    open_cases = [c for c in SOLVE_CASES if c[2] == "open"]
    ewald_cases = [c for c in SOLVE_CASES if c[2] == "ewald"]
    with ThreadPoolExecutor(1) as pool:
        ref = jax_solves()
        cfg_o, cfg_p = ref[("setup", False)][1], ref[("setup", True)][1]
        future = ranks_meanwhile(pool, sc.rank_gravity_solve_groups, P, tmp_path,
                                 [(setup_o, cfg_o, open_cases, None),
                                  (setup_p, cfg_p, ewald_cases, shifts)])
        out = future.result()
    for name, over, kind, mode in SOLVE_CASES:
        rax, regrav = ref["open" if name in ("open_sparse_let", "let_bitmask") else
                          "ewald" if kind == "ewald" else name]
        ax = np.concatenate([o[name]["ax"] for o in out])
        np.testing.assert_allclose(ax, rax, rtol=1e-2, atol=2e-3 * float(np.abs(rax).max()),
                                   err_msg=name)
        assert len({o[name]["egrav"] for o in out}) == 1, name  # replicated
        assert out[0][name]["egrav"] == pytest.approx(regrav, rel=1e-4), name
        d, cfg = out[0][name]["diag"], out[0][name]["cfg"]
        # the sentinel quiet, the near field within its cap (the Ewald
        # passes' m2p high water is the driver's to re-size, as there)
        assert d["p2p_max"] <= cfg["p2p_cap"], (name, d)
        if kind == "open":
            assert d["m2p_max"] <= cfg["m2p_cap"], (name, d)
        if cfg["let_cap"] > 0:
            assert 0 < d["let_max"] <= cfg["let_cap"], (name, d)
            if cfg["super_factor"] == 0:  # the blocks scan the essential set
                assert d["compact_width"] <= cfg["let_cap"], (name, d)
        else:
            assert d["let_max"] == 0, name
        if mode == "sparse":
            win = out[0][name]["win"]
            assert len(win) == P - 1 and max(win) <= 512 // P, (name, win)
            assert "halo_rows" in d and d["halo_occ"] <= 1.0, (name, d)


# ---------------------------------------------------------------------------
# whole steps: VE and std with self-gravity, std-cooling
# ---------------------------------------------------------------------------


def _evrard(side, k=4):
    state, box, const = jax_init_evrard(side)
    return _trim(state, k), box, const


@functools.lru_cache(maxsize=None)
def jax_grav_steps():
    """The JAX package's one-device steps (Pallas in interpret mode): VE
    Evrard 16 at theta 0.5 and std Evrard 20 at theta 0.8."""
    out = {}
    for side, prop, theta in ((16, "ve", 0.5), (20, "std", 0.8)):
        state, box, const = _evrard(side)
        sim = JaxSimulation(state, box, const, prop=prop, block=512, backend="pallas",
                            theta=theta)
        new, diag = sim._launch()[:2]
        s = new.particles
        out[(side, prop)] = ({f: np.asarray(getattr(s, f)) for f in ("x", "vx", "temp")},
                             {k: np.asarray(v) for k, v in diag.items()})
    return out


def _check_grav_step(name, res, ref_fields, ref_diag):
    vx = np.concatenate([r["vx"] for r in res])
    np.testing.assert_allclose(vx, ref_fields["vx"], rtol=1e-2, atol=5e-4, err_msg=name)
    d = res[0]["diag"]
    assert d["egrav"] == pytest.approx(float(ref_diag["egrav"]), rel=1e-4), name
    assert d["dt"] == pytest.approx(float(ref_diag["dt"]), rel=1e-5), name
    for r in res:
        assert r["diag"]["egrav"] == d["egrav"] and r["diag"]["dt"] == d["dt"], name
    g = res[0]["gravity"]
    # the partial tail blocks of the slabs accept more nodes than any
    # one-device block: within the caps, not equal
    assert d["m2p_max"] <= g["m2p_cap"] and d["p2p_max"] <= g["p2p_cap"], (name, d, g)
    assert 0 < d["let_max"] <= g["let_cap"], (name, d, g)
    assert res[0]["replays"] == 0, name


@pytest.mark.parametrize("P", [2, 4])
def test_gravity_steps_match_jax(P, tmp_path):
    runs = []
    for side, prop, theta in ((16, "ve", 0.5), (20, "std", 0.8)):
        flat = _flat(*_evrard(side))
        for window in (256, 0):  # the sparse gravity serve, whole slabs
            runs.append((flat, {"prop": prop, "theta": theta, "grav_window": window}, 1))
    with ThreadPoolExecutor(1) as pool:
        future = ranks_meanwhile(pool, sc.rank_gravity_steps, P, tmp_path, runs)
        ref = jax_grav_steps()
        out = future.result()
    for i, (flat, kw, _) in enumerate(runs):
        side = 16 if kw["prop"] == "ve" else 20
        res = [o[i] for o in out]
        _check_grav_step(f"P={P} {kw}", res, *ref[(side, kw["prop"])])
        ginfo = res[0]["grav_halo"]
        if kw["grav_window"]:
            assert ginfo["mode"] == "sparse" and len(ginfo["caps"]) == P - 1
            rows = res[0]["diag"]
            assert all(f"gshard_rows[{k}]" in rows for k in range(P))
            kinds = [e["stage"] for e in res[0]["exchanges"]]
            assert "gravity" in kinds and "sph" in kinds
        else:
            assert ginfo["mode"] == "windowed" and "gshard_rows[0]" not in res[0]["diag"]


@functools.lru_cache(maxsize=None)
def jax_cooling_steps():
    """The JAX package's one-device std-cooling steps: Sedov 16 (no
    gravity) and evrard-cooling 16 (self-gravity)."""
    from sphexa_tpu.init import make_initializer

    out = {}
    for case in ("sedov", "evrard-cooling"):
        state, box, const = (jax_init_sedov(16) if case == "sedov"
                             else make_initializer(case)(16))
        state = _trim(state)
        sim = JaxSimulation(state, box, const, prop="std-cooling", block=512,
                            backend="pallas")
        new, diag = sim._launch()[:2]
        out[case] = (_flat(state, box, const),
                     {"temp": np.asarray(new.particles.temp), "hi": np.asarray(new.chem.hi)},
                     float(diag["dt"]))
    return out


@pytest.mark.parametrize("P", [2, 4])
def test_std_cooling_matches_jax(P, tmp_path):
    from sphexa_torch.init import make_initializer
    from sphexa_torch.convert import state_to_numpy

    runs = []
    for case in ("sedov", "evrard-cooling"):
        state, box, const = make_initializer(case)(16, device="cpu")
        n = state.n // 4 * 4
        state = dataclasses.replace(state, **{
            f.name: getattr(state, f.name)[:n] for f in dataclasses.fields(state)
            if getattr(state, f.name).dim() == 1})
        runs.append((state_to_numpy(state, box, const), {"prop": "std-cooling"}, 1))
    with ThreadPoolExecutor(1) as pool:
        future = ranks_meanwhile(pool, sc.rank_gravity_steps, P, tmp_path, runs)
        ref = jax_cooling_steps()
        out = future.result()
    for i, case in enumerate(("sedov", "evrard-cooling")):
        res = [o[i] for o in out]
        _, fields, dt = ref[case]
        temp = np.concatenate([r["temp"] for r in res])
        hi = np.concatenate([r["chem_hi"] for r in res])
        np.testing.assert_allclose(temp, fields["temp"], rtol=1e-4, atol=1e-7, err_msg=case)
        np.testing.assert_allclose(hi, fields["hi"], rtol=1e-5, atol=1e-8, err_msg=case)
        assert res[0]["diag"]["dt"] == pytest.approx(dt, rel=1e-5), case
        assert len({r["diag"]["dt_cool"] for r in res}) == 1, case  # a global minimum
        assert len({r["diag"]["du_cool_min"] for r in res}) == 1, case
        if case == "evrard-cooling":
            assert "egrav" in res[0]["diag"]


# ---------------------------------------------------------------------------
# the escape sentinel, the regrow, the CLI, the refusals
# ---------------------------------------------------------------------------


def test_gravity_sentinel_trips_and_simulation_regrows(tmp_path):
    flat = _flat(*_evrard(16, 2))
    runs = [(flat, {"prop": "ve"}, 1), (flat, {"prop": "ve", "grav_margin": 0.02}, 1)]
    out = spawn(sc.rank_grav_sentinel, 2, args=(flat, (32,), runs), workdir=str(tmp_path),
                device="cpu", threads=1, timeout=JOIN_TIMEOUT)
    for o in out:
        assert o["forced"]["p2p_max"] == o["forced"]["p2p_cap"] + 1, o["forced"]
    good, regrown = ([o["runs"][i] for o in out] for i in range(2))
    assert good[0]["replays"] == 0 and good[0]["trips"] == 0
    assert regrown[0]["trips"] >= 1 and regrown[0]["replays"] >= 1, regrown[0]
    assert regrown[0]["grav_cells"][0] > regrown[0]["grav_cells0"][0]
    # the replay lands on the well-sized run's step
    for a, b in zip(good, regrown):
        np.testing.assert_array_equal(a["vx"], b["vx"])
        assert a["diag"]["egrav"] == b["diag"]["egrav"]


def _cli(args, cwd):
    env = {**os.environ, "PYTHONPATH": ROOT}
    return subprocess.run([sys.executable, "-m", "sphexa_torch.app.main", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_devices_evrard_matches_one_device(tmp_path):
    """``--devices 2 --init evrard --prop ve --device cpu`` (Evrard 12:
    920 rows, no trim) against the one-device CLI's constants.txt."""
    base = ["--init", "evrard", "-n", "12", "-s", "2", "--prop", "ve", "--device", "cpu",
            "--quiet"]
    with ThreadPoolExecutor(1) as pool:
        sharded = pool.submit(_cli, base + ["--devices", "2", "-o", str(tmp_path / "two")],
                              tmp_path)
        one = _cli(base + ["-o", str(tmp_path / "one")], tmp_path)
        two = sharded.result()
    assert one.returncode == 0, one.stderr
    assert two.returncode == 0, two.stderr
    a = np.loadtxt(tmp_path / "one" / "constants.txt", ndmin=2)
    b = np.loadtxt(tmp_path / "two" / "constants.txt", ndmin=2)
    assert a.shape == b.shape == (2, 7)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(b[:, 1:3], a[:, 1:3], rtol=1e-5)  # t, dt
    np.testing.assert_allclose(b[:, 3], a[:, 3], rtol=1e-4)  # etot
    np.testing.assert_allclose(b[:, 6], a[:, 6], rtol=1e-4)  # egrav


def test_p2p_jdata_plain_form():
    """K12's plain version in its jdata form: the targets' own arrays as
    the j-buffer give the one-device result bit for bit; the same ranges
    moved into a j-buffer [own rows | other rows] give the same sums."""
    (xs, ys, zs, ms, hs, skeys, box, gtree, meta, jcfg), setup = _random_setup(False, n=256)
    arr = [torch.as_tensor(setup[f].copy()) for f in ("x", "y", "z", "m", "h")]
    keys = torch.as_tensor(setup["keys"])
    from sphexa_torch.gravity.tree import linkage_from_leaves

    tree, pmeta = linkage_from_leaves(setup["leaf"])
    cfg = tt.GravityConfig(**_cfg_fields(jcfg, m2p_cap_margin=1.3))
    mps = tt.compute_multipoles(*arr[:4], keys, tree, pmeta)
    lists = tt.classify(*arr[:3], sc._box_from(setup["box"], "cpu"), tree, pmeta, cfg,
                        mps[0], mps[1])
    start, length = tt._p2p_leaf_ranges(lists["p2p"], lists["p2p_ok"], tree, mps[3],
                                        pmeta.num_nodes)
    z3 = torch.zeros(3)
    ref = tt._pallas_p2p(*arr, z3, False, cfg, start, length)
    same = tt._pallas_p2p(*arr, z3, False, cfg, start, length, jdata=tuple(arr))
    for a, b in zip(ref, same):
        assert torch.equal(a, b)
    # the leaves before a leaf edge near the middle read from a copy of
    # their rows in an annex behind the own rows (as halo rows sit); the
    # self pairs there are no longer dropped, but add exactly 0 (d = 0, no
    # shift)
    n, edges = arr[0].shape[0], mps[3]
    half = int(edges[edges.shape[0] // 2])
    jd = tuple(torch.cat([a, a[:half]]) for a in arr)
    moved = torch.where(start + length <= half, start + n, start).to(torch.int32)
    assert bool((moved >= n).any()) and bool((moved < n).any())
    got = tt._pallas_p2p(*arr, z3, False, cfg, moved, length, jdata=jd)
    for a, b in zip(ref, got):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()))
