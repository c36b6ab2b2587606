"""The port's foundations against the JAX package on the CPU: SFC keys and
sort order (bitwise), Sedov and Gresho-Chan initial conditions (equal),
the kernel fit, h update, EOS, the density time step and the
position/energy update (float32 tolerances)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_gresho_chan as jax_init_gresho_chan
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.propagator import _sort_by_keys as jax_sort_by_keys
from sphexa_tpu.sfc.box import BoundaryType as JBT
from sphexa_tpu.sfc.box import Box as JBox
from sphexa_tpu.sfc.box import apply_pbc_xyz as jax_pbc
from sphexa_tpu.sfc.keys import compute_sfc_keys as jax_keys
from sphexa_tpu.sph import kernels as jk
from sphexa_tpu.sph.hydro_std import compute_eos_std as jax_eos
from sphexa_tpu.sph.particles import SimConstants as JConst
from sphexa_tpu.sph.positions import compute_positions as jax_positions
from sphexa_tpu.sph.timestep import rho_timestep as jax_rho_timestep

from sphexa_torch.init import init_gresho_chan, init_sedov
from sphexa_torch.propagator import _sort_by_keys
from sphexa_torch.sfc.box import BoundaryType, Box, apply_pbc_xyz
from sphexa_torch.sfc.keys import compute_sfc_keys
from sphexa_torch.sph import kernels as tk
from sphexa_torch.sph.hydro_std import compute_eos_std
from sphexa_torch.sph.particles import SimConstants
from sphexa_torch.sph.positions import compute_positions
from sphexa_torch.sph.timestep import rho_timestep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def T(a):
    """A torch copy (never a view of a buffer JAX may also hold)."""
    return torch.tensor(np.array(a))


def J(a):
    return jnp.array(np.array(a))


def _edge_coords(rng, lo, hi, n_rand=2000):
    """Coordinates on key-cell edges, at the box faces, one ulp either side
    of both, and uniformly random ones (float32)."""
    lo, hi = np.float32(lo), np.float32(hi)
    k = np.arange(0, 1025, 37)
    edges = (lo + (hi - lo) * (k / 1024.0)).astype(np.float32)
    edges = np.concatenate([edges, [lo, hi]]).astype(np.float32)
    near = np.concatenate([np.nextafter(edges, np.float32(-np.inf)),
                           np.nextafter(edges, np.float32(np.inf))])
    rand = rng.uniform(lo, hi, n_rand).astype(np.float32)
    return np.concatenate([edges, near, rand]).astype(np.float32)


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
@pytest.mark.parametrize("bounds", [
    ((-0.5, 0.5),) * 3,
    ((-1.0, 3.0), (0.25, 0.75), (-2.0, -1.5)),
], ids=["cube", "slab"])
def test_keys_and_order_bitwise(curve, bounds):
    rng = np.random.default_rng(11)
    cols = [_edge_coords(rng, lo, hi) for lo, hi in bounds]
    n = min(len(c) for c in cols)
    xyz = [rng.permutation(c)[:n] for c in cols]
    (x0, x1), (y0, y1), (z0, z1) = bounds
    jbox = JBox.create(x0, x1, y0, y1, z0, z1, boundary=JBT.open)
    tbox = Box.create(x0, x1, y0, y1, z0, z1, boundary=BoundaryType.open)
    kj = np.asarray(jax_keys(*[J(a) for a in xyz], jbox, curve=curve))
    kt = compute_sfc_keys(*[T(a) for a in xyz], tbox, curve=curve).numpy()
    assert kt.dtype == np.int64
    np.testing.assert_array_equal(kt, kj.astype(np.int64))
    # stable argsort order: duplicates keep input order in both packages
    np.testing.assert_array_equal(np.argsort(kt, kind="stable"),
                                  np.asarray(jnp.argsort(J(kj))))


@pytest.mark.parametrize("side", [8, 12])
def test_sedov_init_and_sort_equal(side):
    js, jb, jc = jax_init_sedov(side)
    ts, tb, tc = init_sedov(side, device="cpu")
    for f in dataclasses.fields(js):
        np.testing.assert_array_equal(getattr(ts, f.name).numpy(),
                                      np.asarray(getattr(js, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(tb.lo.numpy(), np.asarray(jb.lo))
    np.testing.assert_array_equal(tb.hi.numpy(), np.asarray(jb.hi))
    assert tuple(int(b) for b in tb.boundaries) == tuple(int(b) for b in jb.boundaries)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)

    jss, jkeys, _ = jax_sort_by_keys(js, jb, "hilbert")
    tss, tkeys, _ = _sort_by_keys(ts, tb, "hilbert")
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys).astype(np.int64))
    for f in ("x", "y", "z", "h", "temp"):
        np.testing.assert_array_equal(getattr(tss, f).numpy(), np.asarray(getattr(jss, f)))


@pytest.mark.parametrize("side", [10, 20])
def test_gresho_chan_init_equal(side):
    """The thin periodic slab (jittered lattice, seed 42) and its vortex
    fields equal the JAX package's."""
    js, jb, jc = jax_init_gresho_chan(side)
    ts, tb, tc = init_gresho_chan(side, device="cpu")
    for f in dataclasses.fields(js):
        np.testing.assert_array_equal(getattr(ts, f.name).numpy(),
                                      np.asarray(getattr(js, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(tb.lo.numpy(), np.asarray(jb.lo))
    np.testing.assert_array_equal(tb.hi.numpy(), np.asarray(jb.hi))
    assert tuple(int(b) for b in tb.boundaries) == tuple(int(b) for b in jb.boundaries)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert float(ts.vx.abs().max()) > 0.5


def test_rho_timestep():
    """Krho / |max divv|: max, then abs (a contracting flow's divv < 0 does
    not bind it)."""
    const_j, const_t = JConst().normalized(), SimConstants().normalized()
    rng = np.random.default_rng(6)
    for lo, hi in ((-3.0, 2.0), (-5.0, -1.0)):
        divv = rng.uniform(lo, hi, 3000).astype(np.float32)
        assert float(rho_timestep(T(divv), const_t)) == \
            float(jax_rho_timestep(J(divv), const_j))


def test_kernel_fit_and_norm():
    assert tk.kernel_poly_coeffs(6.0, "sinc") == jk.kernel_poly_coeffs(6.0, "sinc")
    assert len(tk.kernel_poly_coeffs(6.0, "sinc")) == 14
    assert SimConstants().normalized().K == JConst().normalized().K
    u = np.linspace(0.0, 4.5, 4001).astype(np.float32)
    coeffs = jk.kernel_poly_coeffs(6.0, "sinc")
    w_j = np.asarray(jk.sinc_poly_eval(J(u), coeffs))
    w_t = tk.sinc_poly_eval(T(u), coeffs).numpy()
    np.testing.assert_allclose(w_t, w_j, rtol=1e-6, atol=1e-12)


def test_update_h_and_eos():
    rng = np.random.default_rng(3)
    nc = rng.integers(0, 300, 5000).astype(np.int32)
    h = rng.uniform(0.005, 0.05, 5000).astype(np.float32)
    np.testing.assert_allclose(tk.update_h(100, T(nc), T(h)).numpy(),
                               np.asarray(jk.update_h(100, J(nc), J(h))),
                               rtol=2e-7)
    temp = rng.uniform(1e-9, 1e-5, 5000).astype(np.float32)
    rho = rng.uniform(0.5, 4.0, 5000).astype(np.float32)
    const_j, const_t = JConst().normalized(), SimConstants().normalized()
    for a, b in zip(compute_eos_std(T(temp), T(rho), const_t),
                    jax_eos(J(temp), J(rho), const_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7)


def test_positions_and_energy_carry():
    """The Press update and the two-sum energy step, including the carry
    (temp_lo) and the exponential fallback for a negative energy."""
    rng = np.random.default_rng(5)
    n = 4000
    f = lambda lo, hi: rng.uniform(lo, hi, n).astype(np.float32)  # noqa: E731
    x, y, z = f(-0.5, 0.5), f(-0.5, 0.5), f(-0.5, 0.5)
    dxm, dym, dzm = f(-1e-6, 1e-6), f(-1e-6, 1e-6), f(-1e-6, 1e-6)
    vx, vy, vz = f(-1, 1), f(-1, 1), f(-1, 1)
    h = f(0.01, 0.02)
    temp, temp_lo = f(1e-8, 1e-5), f(-1e-15, 1e-15)
    du, du_m1 = f(-1e4, 1e4), f(-1e4, 1e4)
    du[:50] = -1e9  # drives s < 0: the exponential fallback
    ax, ay, az = f(-10, 10), f(-10, 10), f(-10, 10)
    fields = (x, y, z, dxm, dym, dzm, vx, vy, vz, h, temp, temp_lo, du, du_m1)
    dt, dt_m1 = np.float32(1.3e-6), np.float32(1.1e-6)
    jbox = JBox.create(-0.5, 0.5, boundary=JBT.periodic)
    tbox = Box.create(-0.5, 0.5, boundary=BoundaryType.periodic)
    const_j, const_t = JConst().normalized(), SimConstants().normalized()
    out_j = jax_positions(tuple(J(a) for a in fields), J(ax),
                          J(ay), J(az), J(dt),
                          J(dt_m1), jbox, const_j)
    out_t = compute_positions(tuple(T(a) for a in fields), T(ax), T(ay), T(az),
                              T(dt), T(dt_m1), tbox, const_t)
    names = ("x", "y", "z", "dx", "dy", "dz", "vx", "vy", "vz", "h", "temp",
             "temp_lo", "du", "du_m1")
    for nm, a, b in zip(names, out_t, out_j):
        b = np.asarray(b)
        assert a.dtype == torch.float32, nm
        # float32 elementwise arithmetic in the same order: equal up to one
        # rounding of the largest term
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-7 * float(np.max(np.abs(b))), err_msg=nm)
    # the carry holds bits the float32 sum dropped: u + lo moves the sum
    assert np.any(out_t[11].numpy() != 0.0)


def test_min_image_fold_bitwise():
    """Minimum-image fold on a mixed periodic/open non-cubic box, with
    separations at exactly +-L/2 (round half to even) and +-3L/2."""
    rng = np.random.default_rng(8)
    bounds = (-0.5, 0.5, 0.0, 2.0, -1.0, 3.0)
    kinds = (JBT.periodic, JBT.open, JBT.periodic)
    jbox = JBox.create(*bounds, boundary=kinds)
    tbox = Box.create(*bounds, boundary=tuple(BoundaryType(int(k)) for k in kinds))
    L = np.array([1.0, 2.0, 4.0], np.float32)
    rs = []
    for d in range(3):
        special = np.array([0.5, -0.5, 1.5, -1.5, 0.0], np.float32) * L[d]
        rs.append(np.concatenate([special, rng.uniform(-2, 2, 3000).astype(np.float32) * L[d]]))
    out_j = jax_pbc(jbox, *[J(r) for r in rs])
    out_t = apply_pbc_xyz(tbox, *[T(r) for r in rs])
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
