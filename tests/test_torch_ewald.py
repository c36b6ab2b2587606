"""The port's Ewald periodic gravity against the JAX package's, on the CPU
(the port's plain versions; the JAX near field in interpret mode or
through its XLA gathers): ``compute_gravity_ewald`` on
tests/test_ewald.py's random cubic configuration, the port against a
float64 particle-level Ewald sum and on a cubic lattice, the corrections
independent of their row chunks, the replica passes' shift and self pair
reaching the near field, three std steps of periodic Sedov 8 with
G = 0.5 against the JAX Simulation, and the refusals the JAX package
makes.

Tolerances: the JAX package's p2p tolerance for the solve (rtol 1e-4,
atol 1e-6 x max|.|), egrav rel 1e-4; tests/test_ewald.py's bounds against
the float64 sum (mean 0.01, max 0.05 of the mean force) and for the
lattice (0.02 of a neighbour pair's force); the steps at
tests/test_torch_gravity_slice.py's (fields rtol 2e-4 / atol 5e-6 x
max|.|, egrav and dt rel 1e-4)."""

import dataclasses
from itertools import product

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_tpu.gravity.ewald import EwaldConfig as JaxEwaldConfig
from sphexa_tpu.gravity.ewald import compute_gravity_ewald as jax_ewald
from sphexa_tpu.gravity.traversal import GravityConfig as JaxGravityConfig
from sphexa_tpu.gravity.traversal import estimate_gravity_caps as jax_estimate
from sphexa_tpu.gravity.tree import build_gravity_tree as jax_build_tree
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.observables.ledger import ObservableSpec as JaxSpec
from sphexa_tpu.sfc.box import BoundaryType as JaxBoundary
from sphexa_tpu.sfc.box import Box as JaxBox
from sphexa_tpu.sfc.keys import compute_sfc_keys as jax_keys
from sphexa_tpu.simulation import Simulation as JaxSimulation

from sphexa_torch.app import main as app
from sphexa_torch.convert import state_from_numpy, state_to_numpy, tree_from_numpy
from sphexa_torch.gravity import ewald as ew
from sphexa_torch.gravity import traversal as tt
from sphexa_torch.init import init_evrard, init_sedov, stretch_box
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.simulation import Simulation

EWALD = {"replicas": 27}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side; torch's default of
    one intra-op thread per core would oversubscribe the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a, dtype=None):
    a = np.asarray(a)
    if dtype is None and a.dtype.kind in "iu":
        dtype = torch.int64
    return torch.as_tensor(a.copy(), dtype=dtype)


def _setup(x, y, z, m, use_pallas=False, theta=0.6, bucket=32):
    """tests/test_ewald.py's _setup: the JAX package's sort, tree and caps
    (margin 2), with the same arrays, tree and caps for the port."""
    box = JaxBox.create(-0.5, 0.5, boundary=JaxBoundary.periodic)
    keys = np.asarray(jax_keys(x, y, z, box))
    order = np.argsort(keys)
    xs, ys, zs, ms = (jnp.asarray(np.asarray(a)[order]) for a in (x, y, z, m))
    skeys = jnp.asarray(keys[order])
    gtree, meta = jax_build_tree(keys[order], bucket_size=bucket)
    jcfg = jax_estimate(xs, ys, zs, ms, skeys, box, gtree, meta,
                        JaxGravityConfig(theta=theta, bucket_size=bucket, G=1.0,
                                         use_pallas=use_pallas), margin=2.0)
    tree, tmeta = tree_from_numpy(
        {f.name: np.asarray(getattr(gtree, f.name)) for f in dataclasses.fields(gtree)},
        {"num_leaves": meta.num_leaves, "num_nodes": meta.num_nodes,
         "level_ranges": meta.level_ranges}, device="cpu")
    names = {f.name for f in dataclasses.fields(tt.GravityConfig)}
    cfg = tt.GravityConfig(**{k: getattr(jcfg, k) for k in names})
    h = np.full(len(x), 1e-3, np.float32)
    port = ([_t(a) for a in (xs, ys, zs, ms, h)] + [_t(skeys)],
            Box(lo=_t(box.lo), hi=_t(box.hi), boundaries=(BoundaryType.periodic,) * 3),
            tree, tmeta, cfg)
    jax = (xs, ys, zs, ms, jnp.asarray(h), skeys, box, gtree, meta, jcfg)
    return port, jax, order


def _port_ewald(port, ecfg=None):
    arrays, box, tree, meta, cfg = port
    return ew.compute_gravity_ewald(*arrays, box, tree, meta, cfg, ecfg or ew.EwaldConfig())


@pytest.fixture(scope="module")
def random_config():
    """tests/test_ewald.py:54's configuration."""
    rng = np.random.default_rng(5)
    n = 128
    x, y, z = rng.uniform(-0.5, 0.5, (3, n)).astype(np.float32)
    m = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return x, y, z, m


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla_near_field", "kernel_near_field"])
def test_ewald_matches_jax(random_config, use_pallas):
    """The whole periodic solve against the JAX compute_gravity_ewald on
    the same tree and caps: forces, egrav, and the diagnostics folded by
    max over the 27 replica passes."""
    port, jargs, _ = _setup(*random_config, use_pallas=use_pallas)
    ref = jax_ewald(*jargs, JaxEwaldConfig())
    out = _port_ewald(port)
    for name, a, b in zip(("ax", "ay", "az"), out[:3], ref[:3]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)
    assert float(out[3]) == pytest.approx(float(ref[3]), rel=1e-4)
    assert set(out[4]) == set(ew.EWALD_DIAG_KEYS)
    for k in ew.EWALD_DIAG_KEYS:
        assert int(out[4][k]) == int(ref[4][k]), k
    cfg = port[4]
    assert int(out[4]["m2p_max"]) <= cfg.m2p_cap and int(out[4]["p2p_max"]) <= cfg.p2p_cap


def test_corrections_match_jax(random_config):
    """The real-space and k-space corrections against the JAX package's on
    the same root multipole and offsets."""
    from sphexa_tpu.gravity import ewald as jew

    x, y, z, _ = random_config
    rng = np.random.default_rng(9)
    dr = np.stack([x, y, z], axis=1)
    q = rng.normal(0.0, 0.05, 7).astype(np.float32)
    mass, L = np.float32(127.3), np.float32(1.0)
    for tf, jf in ((ew._real_space_correction, jew._real_space_correction),
                   (ew._k_space_correction, jew._k_space_correction)):
        u, a = tf(_t(dr), _t(mass), _t(q), _t(L), ew.EwaldConfig())
        ju, ja = (np.asarray(v) for v in jf(jnp.asarray(dr), jnp.asarray(mass),
                                            jnp.asarray(q), jnp.asarray(L),
                                            JaxEwaldConfig()))
        np.testing.assert_allclose(u.numpy(), ju, rtol=1e-5, atol=1e-6 * np.abs(ju).max())
        np.testing.assert_allclose(a.numpy(), ja, rtol=1e-5, atol=1e-6 * np.abs(ja).max())


def test_corrections_do_not_depend_on_chunks(random_config, monkeypatch):
    """The corrections computed in row chunks of a few rows equal the
    corrections in one chunk."""
    x, y, z, _ = random_config
    dr = _t(np.stack([x, y, z], axis=1))
    args = (torch.tensor(100.0), torch.linspace(-0.1, 0.1, 7), torch.tensor(1.0),
            ew.EwaldConfig())
    whole = [ew._real_space_correction(dr, *args), ew._k_space_correction(dr, *args)]
    monkeypatch.setitem(ew.CHUNK_ELEMS, "cpu", 7 * 2 * 343)
    assert len(ew._row_chunks(dr.shape[0], 343, dr.device)) == -(-dr.shape[0] // 7)
    parts = [ew._real_space_correction(dr, *args), ew._k_space_correction(dr, *args)]
    for (u0, a0), (u1, a1) in zip(whole, parts):
        torch.testing.assert_close(u1, u0)
        torch.testing.assert_close(a1, a0)


def test_replica_passes_hand_the_shift_to_the_near_field(random_config, monkeypatch):
    """Each of the 27 passes gives the near field its (3,) float32 shift,
    shell x L in the table's order, and the self pair in every pass but
    the base one; one multipole upsweep serves them all."""
    port, _, _ = _setup(*random_config)
    seen, ups = [], []
    real_p2p, real_mp = tt._pallas_p2p, ew.compute_multipoles

    def spy(x, y, z, m, h, shift, allow_self, cfg, starts, lens):
        seen.append((shift.clone(), allow_self))
        return real_p2p(x, y, z, m, h, shift, allow_self, cfg, starts, lens)

    def count(*a, **k):
        ups.append(1)
        return real_mp(*a, **k)

    monkeypatch.setattr(tt, "_pallas_p2p", spy)
    monkeypatch.setattr(ew, "compute_multipoles", count)
    _port_ewald(port)
    shells = np.array(list(product((-1, 0, 1), repeat=3)), np.float32)
    assert len(seen) == EWALD["replicas"] == len(shells) and len(ups) == 1
    for (shift, allow_self), s in zip(seen, shells):
        assert shift.dtype == torch.float32 and shift.shape == (3,)
        np.testing.assert_array_equal(shift.numpy(), s * np.float32(1.0))
        assert allow_self == bool(s.any())


def test_compute_gravity_with_phi_and_shift(random_config):
    """``with_phi`` returns the potential whose 0.5 sum m phi is egrav; a
    shift moves the targets of the classification and M2P."""
    port, _, _ = _setup(*random_config)
    arrays, box, tree, meta, cfg = port
    ax, ay, az, egrav, d0 = tt.compute_gravity(*arrays, box, tree, meta, cfg)
    bx, by, bz, phi, d1 = tt.compute_gravity(*arrays, box, tree, meta, cfg, with_phi=True)
    assert phi.shape == ax.shape
    torch.testing.assert_close(0.5 * torch.sum(arrays[3] * phi), egrav)
    torch.testing.assert_close(bx, ax)
    shift = torch.tensor([1.0, 0.0, 0.0])
    sx, *_ = tt.compute_gravity(*arrays, box, tree, meta, cfg, shift=shift, allow_self=True)
    assert float((sx - ax).abs().max()) > 1e-3 * float(ax.abs().max())
    lists = tt.classify(*arrays[:3], box, tree, meta, cfg, *tt.compute_multipoles(
        *arrays[:4], arrays[5], tree, meta)[:2], shift=shift)
    idx = tt._block_rows(arrays[0].shape[0], cfg.target_block)
    torch.testing.assert_close(lists["tx"], arrays[0][idx] + 1.0)


def test_matches_particle_level_ewald(random_config):
    """tests/test_ewald.py's gold test: the port against a float64
    particle-level Ewald sum on 64 particles."""
    import scipy.special

    x, y, z, m = (a[:64] for a in random_config)
    pos = np.stack([x, y, z], axis=1).astype(np.float64)
    alpha, nshell, kmax = 4.0, 4, 8
    acc = np.zeros((len(m), 3))
    for nx, ny, nz in product(range(-nshell, nshell + 1), repeat=3):
        R = pos[None, :, :] - pos[:, None, :] + np.array([nx, ny, nz])
        r2 = (R ** 2).sum(-1)
        if nx == ny == nz == 0:
            np.fill_diagonal(r2, np.inf)
        r = np.sqrt(r2)
        f = (scipy.special.erfc(alpha * r) / (r * r2)
             + 2 * alpha / np.sqrt(np.pi) * np.exp(-(alpha ** 2) * r2) / r2)
        acc += (m[None, :, None] * f[:, :, None] * R).sum(axis=1)
    for hx, hy, hz in product(range(-kmax, kmax + 1), repeat=3):
        h2 = hx * hx + hy * hy + hz * hz
        if h2 == 0 or h2 > kmax * kmax:
            continue
        k = 2 * np.pi * np.array([hx, hy, hz])
        k2 = (k ** 2).sum()
        ph = pos @ k
        sc, ss = (m * np.cos(ph)).sum(), (m * np.sin(ph)).sum()
        coef = 4 * np.pi / k2 * np.exp(-k2 / (4 * alpha ** 2))
        acc += coef * (-np.sin(ph) * sc + np.cos(ph) * ss)[:, None] * k[None, :]
    port, _, order = _setup(x, y, z, m)
    out = _port_ewald(port)
    ours = np.stack([a.numpy() for a in out[:3]], axis=1)
    ref = acc[order]
    scale = np.linalg.norm(ref, axis=1).mean()
    err = np.linalg.norm(ours - ref, axis=1) / scale
    assert err.mean() < 0.01, err.mean()
    assert err.max() < 0.05, err.max()


def test_cubic_lattice_forces_vanish():
    side = 4
    line = (np.arange(side) + 0.5) / side - 0.5
    zz, yy, xx = np.meshgrid(line, line, line, indexing="ij")
    x, y, z = (a.ravel().astype(np.float32) for a in (xx, yy, zz))
    port, _, _ = _setup(x, y, z, np.ones(side ** 3, np.float32))
    out = _port_ewald(port)
    pair_scale = 1.0 / (1.0 / side) ** 2
    for a in out[:3]:
        assert float(a.abs().max()) / pair_scale < 0.02


def test_ewald_refuses_spherical_multipoles(random_config):
    port, _, _ = _setup(*random_config)
    arrays, box, tree, meta, cfg = port
    with pytest.raises(NotImplementedError, match="open-boundary only"):
        ew.compute_gravity_ewald(*arrays, box, tree, meta,
                                 dataclasses.replace(cfg, multipole_order=4), ew.EwaldConfig())


def test_periodic_sedov_steps_match_jax():
    """Three std steps of periodic Sedov 8 with G = 0.5, each package's
    Simulation from the same input (the JAX one with its Pallas ops in
    interpret mode): the same caps and high waters, dt and egrav, and
    every field."""
    over = {"gravConstant": 0.5}
    js, jb, jc = jax_init_sedov(8, overrides=over)
    jsim = JaxSimulation(js, jb, jc, prop="std", backend="pallas", check_every=1,
                         obs_spec=JaxSpec())
    sim = Simulation(*init_sedov(8, overrides=over, device="cpu"), prop="std", device="cpu",
                     obs_spec=ObservableSpec())
    assert sim.ewald_on and jsim.ewald_on and sim.cfg.ewald == ew.EwaldConfig()
    for k in ("m2p_cap", "p2p_cap", "leaf_cap", "target_block", "compaction"):
        assert getattr(sim.cfg.gravity, k) == getattr(jsim._cfg.gravity, k), k
    for it in range(3):
        jd, td = jsim.step(), sim.step()
        for k in ("m2p_max", "p2p_max", "leaf_occ", "c_max", "nc_max", "occupancy",
                  "dt_limiter"):
            assert td[k] == float(jd[k]), (it, k)
        for k in ("dt", "egrav", "obs_etot"):
            assert td[k] == pytest.approx(float(jd[k]), rel=1e-4), (it, k)
    out, _, _ = state_to_numpy(sim.state, sim.box, sim.const)
    for f in dataclasses.fields(jsim.state):
        a, b = out[f.name], np.asarray(getattr(jsim.state, f.name))
        ref = np.asarray(jsim.state.temp) if f.name == "temp_lo" else b
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-6 * float(np.max(np.abs(ref))),
                                   err_msg=f.name)


def test_cli_periodic_gravity_runs(tmp_path, capsys):
    """``--init sedov --G 0.5`` runs Ewald gravity through the CLI."""
    assert app.main(["--init", "sedov", "-n", "6", "-s", "2", "--G", "0.5", "--device", "cpu",
                     "-o", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "it     2" in out and "egrav=" in out and "lists off" in out
    rows = np.loadtxt(tmp_path / "constants.txt", comments="#", ndmin=2)
    assert rows.shape[0] == 2 and np.all(np.isfinite(rows))


def _sedov_gravity_box(z_scale, boundaries):
    """Sedov 8 with G = 1, stretched in z and with other boundaries."""
    fields, box, const = state_to_numpy(*init_sedov(8, device="cpu"))
    fields, box = stretch_box(fields, box, z_scale, [int(b) for b in boundaries])
    return state_from_numpy(fields, box, {**const, "g": 1.0}, device="cpu")


def test_mixed_boundaries_refused():
    with pytest.raises(NotImplementedError, match="not mixed ones"):
        Simulation(*_sedov_gravity_box(1.0, (BoundaryType.periodic, BoundaryType.open,
                                             BoundaryType.open)), device="cpu")


def test_non_cubic_periodic_box_refused():
    with pytest.raises(ValueError, match="cubic periodic box"):
        Simulation(*_sedov_gravity_box(1.5, (BoundaryType.periodic,) * 3), device="cpu")
    # an open box with gravity takes no Ewald path
    sim = Simulation(*init_evrard(8, device="cpu"), prop="ve", device="cpu")
    assert sim.gravity_on and not sim.ewald_on and sim.cfg.ewald is None
