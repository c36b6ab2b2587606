"""The port's gather backend against the JAX package's XLA path, on the
CPU: ``find_neighbors`` and its sizing helpers bit for bit, each gather
op within its tolerance on the JAX-made lists, and the row blocks.

Neighbour search: the cases of tests/test_neighbors.py (periodic, open,
large h on a coarse grid, varying h at ngmax 300, truncation at ngmax 10,
empty regions), a window too small (occupancy cap + 1), and pairs placed
where XLA's FMA contraction of the squared distance decides the hit;
nidx, nmask, nc and occupancy exact, ``estimate_cell_cap`` and
``estimate_group_window`` exact.

The gather near field: compute_gravity's XLA form on Evrard 16 against
the JAX package's (use_pallas False) in a shifted pass with the self
pair, rtol 1e-4 / atol 1e-6 max|.| (its p2p tolerance).

Ops: jittered Sedov 12 (both packages on the same numpy inputs) at
ngmax 150 (no row truncated) and at ngmax 40 (every row truncated),
each op of the port fed the JAX chain's inputs and lists. Tolerances are
the engine counterparts' in tests/test_torch_ops.py and
tests/test_torch_ve_ops.py: density and xmass rtol 1e-5; IAD rtol 1e-4 /
atol 1e-5 max|c11|; kx rtol 1e-5, gradh rtol 5e-4 / atol 1e-5; divv,
curlv and gradv rtol 1e-4 / atol 1e-5 max|divv|; alpha rtol 1e-4 / atol
1e-6; std a and du rtol 1e-4 / atol 5e-6 max|.|, min dt rel 1e-5; VE a
and du rtol 2e-4 / atol 1e-5 max|.|, min dt rel 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.gravity.traversal import GravityConfig as JaxGravityConfig
from sphexa_tpu.gravity.traversal import compute_gravity as jax_compute_gravity
from sphexa_tpu.gravity.traversal import estimate_gravity_caps as jax_estimate
from sphexa_tpu.gravity.tree import linkage_from_leaves as jax_linkage
from sphexa_tpu.init import init_evrard as jax_init_evrard
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.neighbors import cell_list as jcl
from sphexa_tpu.parallel.sizing import leaf_array_from_device_keys as jax_leaf_array
from sphexa_tpu.propagator import _sort_by_keys as jax_sort_by_keys
from sphexa_tpu.sfc import Box as JBox
from sphexa_tpu.sfc import BoundaryType as JBT
from sphexa_tpu.sfc import compute_sfc_keys as jax_keys
from sphexa_tpu.sfc.box import make_global_box as jax_global_box
from sphexa_tpu.simulation import make_propagator_config as jax_config
from sphexa_tpu.sph import hydro_std as jstd
from sphexa_tpu.sph import hydro_ve as jve

from sphexa_torch.convert import neighbor_config_from_dict, state_from_numpy, tree_from_numpy
from sphexa_torch.gravity.traversal import GravityConfig, compute_gravity
from sphexa_torch.init import jitter_sedov
from sphexa_torch.neighbors import cell_list as tcl
from sphexa_torch.propagator import _sort_by_keys
from sphexa_torch.sfc.box import Box, BoundaryType
from sphexa_torch.simulation import make_propagator_config
from sphexa_torch.sph import hydro_std, hydro_ve
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.util.blocking import blocked_map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def T(a):
    return torch.tensor(np.array(a))


# ---------------------------------------------------------------------------
# find_neighbors
# ---------------------------------------------------------------------------


def _uniform(rng, n, boundary, h_val, lo=-0.5, hi=0.5):
    pos = [rng.uniform(lo, hi, n).astype(np.float32) for _ in range(3)]
    return (-0.5, 0.5), boundary, pos, np.full(n, h_val, np.float32)


def _fma_pairs(rng, npairs=32):
    """Pairs (i at a lattice point, j at i - d) in a box of side 4 whose
    squared distance rounds differently with and without XLA's FMA
    contraction, each i's h set so that (2h)^2 lands on the larger of the
    two: the hit is decided by the contraction. d's components are
    multiples of 2^-20, so that x_i - x_j is d exactly."""
    f32 = np.float32
    pts, hs = [], []
    while len(hs) < 2 * npairs:
        d = (rng.integers(50_000, 180_000, 3) / 2**20).astype(f32)
        plain = f32(f32(f32(d[0] * d[0]) + f32(d[1] * d[1])) + f32(d[2] * d[2]))
        inner = f32(np.float64(d[0]) * d[0] + np.float64(f32(d[1] * d[1])))
        fma = f32(np.float64(d[2]) * d[2] + np.float64(inner))
        if plain == fma:
            continue
        target = max(plain, fma)
        h = f32(np.sqrt(target) / 2)
        for _ in range(64):
            r2 = f32(f32(2 * h) * f32(2 * h))
            if r2 == target:
                break
            h = np.nextafter(h, f32(1) if r2 < target else f32(0))
        if f32(f32(2 * h) * f32(2 * h)) != target:
            continue
        k = len(hs) // 2
        p = np.array([k % 4, (k // 4) % 4, k // 16], f32) * f32(0.75) - f32(1.5)
        pts += [p, p - d]
        hs += [h, f32(0.01)]
    pos = np.stack(pts).astype(np.float32)
    return (-2.0, 2.0), JBT.open, [pos[:, 0], pos[:, 1], pos[:, 2]], np.asarray(hs, f32)


#: name -> (seed, case maker, ngmax, block, window or None); the first six
#: are tests/test_neighbors.py's cases
NEIGHBOR_CASES = {
    "periodic": (0, lambda r: _uniform(r, 500, JBT.periodic, 0.08), 200, 256, None),
    "open": (1, lambda r: _uniform(r, 500, JBT.open, 0.08), 200, 256, None),
    "large_h_coarse": (2, lambda r: _uniform(r, 200, JBT.periodic, 0.2), 200, 256, None),
    "varying_h": (3, lambda r: _uniform(r, 400, JBT.periodic, 0.08), 300, 128, None),
    "truncation": (4, lambda r: _uniform(r, 300, JBT.periodic, 0.15), 10, 64, None),
    "empty_regions": (5, lambda r: _uniform(r, 200, JBT.periodic, 0.03, -0.5, -0.3), 100, 64,
                      None),
    "window_too_small": (6, lambda r: _uniform(r, 500, JBT.open, 0.08), 50, 256, 1),
    "fma_contraction": (7, _fma_pairs, 4, 2048, None),
}


@pytest.mark.parametrize("name", list(NEIGHBOR_CASES))
def test_find_neighbors_matches_jax(name):
    """nidx, nmask, nc and occupancy equal the JAX function's bit for bit;
    the sizing helpers equal the JAX package's."""
    seed, build, ngmax, block, window = NEIGHBOR_CASES[name]
    rng = np.random.default_rng(seed)
    (lo, hi), boundary, (x, y, z), h = build(rng)
    if name == "varying_h":
        h = (0.04 + 0.04 * rng.uniform(size=x.shape[0])).astype(np.float32)
    if name == "fma_contraction":
        # row 2k's hit on row 2k + 1 as the contraction rounds: a plain
        # float32 squared distance decides every one of them the other way
        d = [(a[0::2] - a[1::2]).astype(np.float64) for a in (x, y, z)]
        inner = (d[0] * d[0] + (d[1] * d[1]).astype(np.float32)).astype(np.float32)
        d2 = (d[2] * d[2] + inner).astype(np.float32)
        expect_hits = int((d2 < (2 * h[0::2]) * (2 * h[0::2])).sum())
    jbox = JBox.create(lo, hi, boundary=boundary)
    keys = np.asarray(jax_keys(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jbox))
    o = np.argsort(keys, kind="stable")
    x, y, z, h, keys = x[o], y[o], z[o], h[o], keys[o]
    lengths = np.asarray(jbox.lengths)
    level = jcl.choose_grid_level(lengths, h.max())
    cap = jcl.estimate_cell_cap(keys, level)
    w = window or jcl.estimate_group_window(x, y, z, h, lengths, level, group=64)
    assert tcl.estimate_cell_cap(T(keys.astype(np.int64)), level) == cap
    assert tcl.estimate_group_window(T(x), T(y), T(z), T(h), T(lengths), level, 64) == \
        jcl.estimate_group_window(x, y, z, h, lengths, level, group=64)
    jcfg = jcl.NeighborConfig(level=level, cap=cap, ngmax=ngmax, block=block, window=w)
    want = [np.asarray(a) for a in jcl.find_neighbors(
        *(jnp.asarray(a) for a in (x, y, z, h, keys)), jbox, jcfg)]
    box = Box.create(lo, hi, boundary=BoundaryType(int(boundary)))
    got = tcl.find_neighbors(T(x), T(y), T(z), T(h), T(keys.astype(np.int64)), box,
                             neighbor_config_from_dict(dataclasses.asdict(jcfg)))
    assert [a.dtype for a in got] == [torch.int32, torch.bool, torch.int32, torch.int32]
    for label, a, b in zip(("nidx", "nmask", "nc", "occupancy"), got, want):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=label)
    if name == "window_too_small":
        assert int(got[3]) == cap + 1
    if name == "truncation":
        assert (want[2] > ngmax).all()
    if name == "fma_contraction":
        assert 0 < int(want[2].sum()) == expect_hits < x.shape[0] // 2


# ---------------------------------------------------------------------------
# the gather ops on the JAX-made lists
# ---------------------------------------------------------------------------


def _jax_chain(s, nidx, nmask, nc, jb, jc, blk):
    """The JAX package's std and VE gather ops on one sorted state, each
    on the previous op's outputs; both divv/curlv forms and both VE
    momentum forms (one jit)."""
    geo = (s.x, s.y, s.z, s.h)
    vel = (s.vx, s.vy, s.vz)
    L = (nidx, nmask)
    out = {"nc": nc}
    out["rho"] = jstd.compute_density(*geo, s.m, *L, jb, jc, blk)
    out["p"], out["c"] = jstd.compute_eos_std(s.temp, out["rho"], jc)
    out["cs"] = jstd.compute_iad(*geo, s.m / out["rho"], *L, jb, jc, blk)
    out["mom_std"] = jstd.compute_momentum_energy_std(
        s.x, s.y, s.z, *vel, s.h, s.m, out["rho"], out["p"], out["c"], *out["cs"], *L, jb, jc,
        blk)
    xm = jve.compute_xmass(*geo, s.m, *L, jb, jc, blk)
    kx, gradh = jve.compute_ve_def_gradh(*geo, s.m, xm, *L, jb, jc, blk)
    prho, cv, _, _ = jve.compute_eos_ve(s.temp, s.m, kx, xm, gradh, jc)
    vcs = jstd.compute_iad(*geo, xm / kx, *L, jb, jc, blk)
    out.update(xm=xm, kx=kx, gradh=gradh, prho=prho, cv=cv, vcs=vcs)
    for gv in (False, True):
        out[f"dv{int(gv)}"] = jve.compute_iad_divv_curlv(
            s.x, s.y, s.z, *vel, s.h, kx, xm, *vcs, *L, jb, jc, blk, with_gradv=gv)
    out["alpha"] = jve.compute_av_switches(s.x, s.y, s.z, *vel, s.h, cv, kx, xm,
                                           out["dv0"][0], s.alpha, *vcs, *L, jb, s.min_dt, jc,
                                           blk)
    for av_clean in (False, True):
        gv = tuple(out["dv1"][2:]) if av_clean else None
        out[f"mom_ve{int(av_clean)}"] = jve.compute_momentum_energy_ve(
            s.x, s.y, s.z, *vel, s.h, s.m, prho, cv, kx, xm, out["alpha"], *vcs, *L, nc, jb, jc,
            blk, gradv=gv)
    return out


@pytest.fixture(scope="module", params=[150, 40], ids=["ngmax150", "ngmax40"])
def case(request):
    """Jittered Sedov 12 sorted by both packages, the JAX lists at the
    given ngmax, and the JAX package's std and VE gather chains."""
    ngmax, side = request.param, 12
    js0, jb, jc = jax_init_sedov(side)
    fields = {f.name: np.array(getattr(js0, f.name)) for f in dataclasses.fields(js0)}
    fields = jitter_sedov(fields, side, seed=side)
    js = dataclasses.replace(js0, **{k: jnp.asarray(v) for k, v in fields.items()})
    jcfg = jax_config(js, jb, jc, backend="xla", ngmax=ngmax)
    box = {"lo": np.array(jb.lo), "hi": np.array(jb.hi),
           "boundaries": [int(b) for b in jb.boundaries]}
    ts, tb, tc = state_from_numpy(fields, box, dataclasses.asdict(jc), device="cpu")
    tcfg = make_propagator_config(ts, tb, tc, ngmax=ngmax, backend="xla")
    assert dataclasses.asdict(tcfg.nbr) == {
        k: getattr(jcfg.nbr, k) for k in dataclasses.asdict(tcfg.nbr)}
    jss, jkeys, _ = jax_sort_by_keys(js, jb, "hilbert")
    tss, tkeys, _ = _sort_by_keys(ts, tb, "hilbert")
    np.testing.assert_array_equal(tss.x.numpy(), np.asarray(jss.x))
    nbr = jcfg.nbr
    nidx, nmask, nc, _ = jax.jit(lambda *a: jcl.find_neighbors(*a, jb, nbr))(
        jss.x, jss.y, jss.z, jss.h, jkeys)
    tlists = tcl.find_neighbors(tss.x, tss.y, tss.z, tss.h, tkeys, tb, tcfg.nbr)
    np.testing.assert_array_equal(tlists[0].numpy(), np.asarray(nidx))
    if ngmax == 40:
        assert int((np.asarray(nc) > ngmax).sum()) == nc.shape[0]

    out = jax.jit(lambda st, nidx, nmask, nc: _jax_chain(st, nidx, nmask, nc, jb, jc,
                                                         nbr.block))(jss, nidx, nmask, nc)
    return {"ngmax": ngmax, "js": jss, "tss": tss, "tb": tb, "tc": tc, "tkeys": tkeys,
            "tcfg": tcfg, "lists": (T(nidx), T(nmask)), "nc": T(nc), "j": out}


def _args(c, names):
    s = c["js"]
    return [T(getattr(s, n)) for n in names]


def _close(got, want, rtol, atol_scale=0.0, name=""):
    want = np.asarray(want)
    atol = atol_scale * (float(np.max(np.abs(want))) + 1e-12) if atol_scale else 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol, err_msg=name)


def _density(c, block=2048):
    return hydro_std.compute_density(*_args(c, "xyzhm"), *c["lists"], c["tb"], c["tc"], block)


def test_density(case):
    c, j = case, case["j"]
    _close(_density(c), j["rho"], 1e-5, name="rho")
    if c["ngmax"] == 40:
        # every row truncated: the engine's sum over all pairs within 2h is
        # a different density, which the gather op does not follow
        tss = c["tss"]
        rho_e, _, _ = pe.density_plain(tss.x, tss.y, tss.z, tss.h, tss.m, c["tkeys"], c["tb"],
                                       c["tc"], c["tcfg"].nbr)
        rel = np.abs(rho_e.numpy() / np.asarray(j["rho"]) - 1.0)
        assert rel.max() > 1e-2


def test_iad(case):
    c, j = case, case["j"]
    cs = hydro_std.compute_iad(*_args(c, "xyzh"), T(c["js"].m) / T(j["rho"]), *c["lists"],
                               c["tb"], c["tc"])
    scale = float(np.max(np.abs(np.asarray(j["cs"][0]))))
    for k, (a, b) in enumerate(zip(cs, j["cs"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=f"c{k}")


def test_momentum_energy_std(case):
    c, j = case, case["j"]
    got = hydro_std.compute_momentum_energy_std(
        *_args(c, ("x", "y", "z", "vx", "vy", "vz", "h", "m")), T(j["rho"]), T(j["p"]),
        T(j["c"]), *(T(a) for a in j["cs"]), *c["lists"], c["tb"], c["tc"])
    for name, a, b in zip(("ax", "ay", "az", "du"), got[:4], j["mom_std"][:4]):
        _close(a, b, 1e-4, 5e-6, name)
    assert float(got[4]) == pytest.approx(float(j["mom_std"][4]), rel=1e-5)


def test_xmass_gradh(case):
    c, j = case, case["j"]
    xm = hydro_ve.compute_xmass(*_args(c, "xyzhm"), *c["lists"], c["tb"], c["tc"])
    _close(xm, j["xm"], 1e-5, name="xm")
    kx, gradh = hydro_ve.compute_ve_def_gradh(*_args(c, "xyzhm"), T(j["xm"]), *c["lists"],
                                              c["tb"], c["tc"])
    _close(kx, j["kx"], 1e-5, name="kx")
    np.testing.assert_allclose(gradh.numpy(), np.asarray(j["gradh"]), rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("gradv", [False, True], ids=["plain", "gradv"])
def test_divv_curlv(case, gradv):
    c, j = case, case["j"]
    got = hydro_ve.compute_iad_divv_curlv(
        *_args(c, ("x", "y", "z", "vx", "vy", "vz", "h")), T(j["kx"]), T(j["xm"]),
        *(T(a) for a in j["vcs"]), *c["lists"], c["tb"], c["tc"], with_gradv=gradv)
    want = j[f"dv{int(gradv)}"]
    assert len(got) == len(want) == (8 if gradv else 2)
    scale = float(np.max(np.abs(np.asarray(want[0]))))
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=f"output {k}")


def test_av_switches(case):
    c, j = case, case["j"]
    s = c["js"]
    alpha = hydro_ve.compute_av_switches(
        *_args(c, ("x", "y", "z", "vx", "vy", "vz", "h")), T(j["cv"]), T(j["kx"]), T(j["xm"]),
        T(j["dv0"][0]), T(s.alpha), *(T(a) for a in j["vcs"]), *c["lists"], c["tb"],
        T(s.min_dt), c["tc"])
    np.testing.assert_allclose(alpha.numpy(), np.asarray(j["alpha"]), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("av_clean", [False, True], ids=["plain", "av_clean"])
def test_momentum_energy_ve(case, av_clean):
    c, j = case, case["j"]
    gv = tuple(T(a) for a in j["dv1"][2:]) if av_clean else None
    got = hydro_ve.compute_momentum_energy_ve(
        *_args(c, ("x", "y", "z", "vx", "vy", "vz", "h", "m")), T(j["prho"]), T(j["cv"]),
        T(j["kx"]), T(j["xm"]), T(j["alpha"]), *(T(a) for a in j["vcs"]), *c["lists"], c["nc"],
        c["tb"], c["tc"], gradv=gv)
    want = j[f"mom_ve{int(av_clean)}"]
    for name, a, b in zip(("ax", "ay", "az", "du"), got[:4], want[:4]):
        _close(a, b, 2e-4, 1e-5, name)
    assert float(got[4]) == pytest.approx(float(want[4]), rel=1e-4)


# ---------------------------------------------------------------------------
# the gather near field
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def evrard():
    """Evrard 16 SFC-sorted, its tree from the JAX package's leaf array,
    the JAX sampled caps of its XLA near field (use_pallas False), and the
    same arrays as port tensors."""
    state, box, _ = jax_init_evrard(16)
    box = jax_global_box(state.x, state.y, state.z, box)
    ss, keys, _ = jax_sort_by_keys(state, box, "hilbert")
    gtree, meta = jax_linkage(jax_leaf_array(keys, bucket_size=64))
    jcfg = jax_estimate(ss.x, ss.y, ss.z, ss.m, keys, box, gtree, meta,
                        JaxGravityConfig(theta=0.5, G=1.0, use_pallas=False))
    tree, tmeta = tree_from_numpy(
        {f.name: np.asarray(getattr(gtree, f.name)) for f in dataclasses.fields(gtree)},
        {"num_leaves": meta.num_leaves, "num_nodes": meta.num_nodes,
         "level_ranges": meta.level_ranges}, device="cpu")
    names = {f.name for f in dataclasses.fields(GravityConfig)}
    port = ([T(getattr(ss, f)) for f in ("x", "y", "z", "m", "h")]
            + [T(np.asarray(keys).astype(np.int64)), Box(lo=T(box.lo), hi=T(box.hi)), tree,
               tmeta, GravityConfig(**{k: getattr(jcfg, k) for k in names})])
    jax_args = (ss.x, ss.y, ss.z, ss.m, ss.h, keys, box, gtree, meta, jcfg)
    return port, jax_args


def test_gather_near_field_matches_jax(evrard):
    """compute_gravity with the gather near field against the JAX
    package's with its XLA near field (use_pallas False) in a replica's
    shifted pass with the self pair kept (the Ewald form; the open box's
    runs in tests/test_torch_gather_slice.py's Evrard steps), at the JAX
    package's p2p tolerance (rtol 1e-4, atol 1e-6 max|.|); the integer
    diagnostics equal."""
    port, jargs = evrard
    shift = (0.3, -0.2, 0.1)
    ref = jax_compute_gravity(*jargs, with_phi=True, shift=jnp.asarray(shift, jnp.float32),
                              allow_self=jnp.asarray(True))
    out = compute_gravity(*port, with_phi=True, gather_p2p=True, shift=torch.tensor(shift),
                          allow_self=True)
    for name, a, b in zip(("ax", "ay", "az", "phi"), out[:4], ref[:4]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)
    for k in ("p2p_max", "leaf_occ", "c_max", "compact_width"):
        assert float(out[4][k]) == float(ref[4][k]), k


# ---------------------------------------------------------------------------
# row blocks
# ---------------------------------------------------------------------------


def _op_outputs(c, op, block):
    j, L, tb, tc = c["j"], c["lists"], c["tb"], c["tc"]
    if op == "density":
        return (_density(c, block),)
    if op == "momentum_std":
        return hydro_std.compute_momentum_energy_std(
            *_args(c, ("x", "y", "z", "vx", "vy", "vz", "h", "m")), T(j["rho"]), T(j["p"]),
            T(j["c"]), *(T(a) for a in j["cs"]), *L, tb, tc, block)
    if op == "divv_gradv":
        return hydro_ve.compute_iad_divv_curlv(
            *_args(c, ("x", "y", "z", "vx", "vy", "vz", "h")), T(j["kx"]), T(j["xm"]),
            *(T(a) for a in j["vcs"]), *L, tb, tc, block, with_gradv=True)
    return hydro_ve.compute_momentum_energy_ve(
        *_args(c, ("x", "y", "z", "vx", "vy", "vz", "h", "m")), T(j["prho"]), T(j["cv"]),
        T(j["kx"]), T(j["xm"]), T(j["alpha"]), *(T(a) for a in j["vcs"]), *L, c["nc"], tb, tc,
        block, gradv=tuple(T(a) for a in j["dv1"][2:]))


@pytest.mark.parametrize("op", ["density", "momentum_std", "divv_gradv", "momentum_ve_clean"])
def test_blocks_change_no_bit(case, op):
    """A row's result does not depend on its block: blocks of 64 and of
    2048 rows (one block, its tail clamped) give the same bits."""
    for a, b in zip(_op_outputs(case, op, 64), _op_outputs(case, op, 2048)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_blocked_map_tail_rows():
    """The tail block's clamped rows are dropped; tuples keep their
    structure."""
    seen = []

    def body(idx):
        seen.append(idx.clone())
        return idx * 2, idx.to(torch.float32)

    a, b = blocked_map(body, 10, 4)
    assert [s.tolist() for s in seen] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 9, 9]]
    assert a.tolist() == [2 * i for i in range(10)] and b.shape == (10,)
