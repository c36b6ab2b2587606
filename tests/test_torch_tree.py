"""The port's cornerstone tree (sphexa_torch/tree: csarray, inject,
continuum; gravity/tree.py build_gravity_tree) against the JAX package's
on the same numpy keys and densities, bit for bit, and the port's device
pyramid (parallel/sizing.leaf_array_from_device_keys) against the port's
compute_octree, as tests/test_parallel.py pins the JAX one."""

import numpy as np
import pytest
import torch

from sphexa_tpu.tree import continuum as jcont
from sphexa_tpu.tree import csarray as jcs
from sphexa_tpu.tree import inject as jinj
from sphexa_torch.tree import continuum as tcont
from sphexa_torch.tree import csarray as tcs
from sphexa_torch.tree import inject as tinj

KEY_RANGE = 1 << 30


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the keys are a few thousand rows."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _random_keys(seed, n):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, KEY_RANGE, n).astype(np.uint64))


def _clustered_keys(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, KEY_RANGE // 1000, 5000)
    b = rng.integers(KEY_RANGE - 500, KEY_RANGE, 5000)
    return np.sort(np.concatenate([a, b]).astype(np.uint64))


KEY_CASES = {
    "random_1000": lambda: _random_keys(1, 1000),
    "random_20000": lambda: _random_keys(2, 20000),
    "clustered": lambda: _clustered_keys(3),
    "empty": lambda: np.zeros(0, np.uint64),
}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_root_and_uniform_trees():
    _same(tcs.make_root_tree(), jcs.make_root_tree())
    for level in (0, 1, 2, 3):
        _same(tcs.make_uniform_tree(level), jcs.make_uniform_tree(level))
        _same(tcs.node_levels(tcs.make_uniform_tree(level)),
              jcs.node_levels(jcs.make_uniform_tree(level)))


@pytest.mark.parametrize("case", sorted(KEY_CASES))
@pytest.mark.parametrize("bucket", [16, 64])
def test_compute_octree_matches_jax(case, bucket):
    keys = KEY_CASES[case]()
    tree, counts = tcs.compute_octree(keys, bucket)
    jtree, jcounts = jcs.compute_octree(keys, bucket)
    _same(tree, jtree)
    _same(counts, jcounts)


@pytest.mark.parametrize("case", ["random_1000", "clustered"])
def test_update_rebalance_counts_step_by_step(case):
    """Every iteration's tree, counts, ops and converged flag, from the
    root; the int64 key tensor gives the numpy keys' results."""
    keys = KEY_CASES[case]()
    tkeys = torch.as_tensor(keys.astype(np.int64))
    tree = jtree = tcs.make_root_tree()
    for _ in range(64):
        counts = tcs.compute_node_counts(tree, keys)
        _same(counts, jcs.compute_node_counts(jtree, keys))
        _same(tcs.compute_node_counts(tree, tkeys), counts)
        ops, first = tcs._node_ops(tree, counts, 32)
        jops, jfirst = jcs._node_ops(jtree, counts, 32)
        _same(ops, jops)
        _same(first, jfirst)
        r, conv = tcs.rebalance_tree(tree, counts, 32)
        jr, jconv = jcs.rebalance_tree(jtree, counts, 32)
        _same(r, jr)
        assert conv == jconv
        tree, counts2, conv = tcs.update_octree(tkeys, tree, 32)
        jtree, jcounts2, jconv = jcs.update_octree(keys, jtree, 32)
        _same(tree, jtree)
        _same(counts2, jcounts2)
        assert conv == jconv
        if conv:
            break
    else:
        pytest.fail("no convergence")


def test_merge_of_sibling_groups_matches_jax():
    """A uniform tree over sparse keys: eight siblings merge into their
    parent (the merged-first path of _node_ops)."""
    keys = _random_keys(5, 40)
    tree = tcs.make_uniform_tree(2)
    counts = tcs.compute_node_counts(tree, keys)
    out, conv = tcs.rebalance_tree(tree, counts, 64)
    jout, jconv = jcs.rebalance_tree(tree, counts, 64)
    _same(out, jout)
    assert conv == jconv and not conv and len(out) < len(tree)


INJECT_CASES = {
    "two_keys": (1, np.array([KEY_RANGE // 64 * 3, KEY_RANGE // 512 * 100], np.uint64)),
    "existing": (2, None),
    "deep": (0, np.array([1, 12345, KEY_RANGE - 1, KEY_RANGE // 8], np.uint64)),
    "bounds": (1, np.array([0, KEY_RANGE, 7 << 24], np.uint64)),
}


@pytest.mark.parametrize("case", sorted(INJECT_CASES))
def test_inject_keys_matches_jax(case):
    level, keys = INJECT_CASES[case]
    tree = tcs.make_uniform_tree(level)
    if keys is None:
        keys = tree[3:5]
    out = tinj.inject_keys(tree, keys)
    _same(out, jinj.inject_keys(tree, keys))
    assert set(keys[(keys > 0) & (keys < KEY_RANGE)].tolist()) <= set(out.tolist())
    _same(tinj.inject_keys(torch.as_tensor(tree.astype(np.int64)),
                           torch.as_tensor(keys.astype(np.int64))), out)


def _uniform(x, y, z):
    return np.ones_like(x)


def _peaked(x, y, z):
    r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2
    return np.exp(-r2 / 0.01)


def _plummer(x, y, z):
    r2 = x * x + y * y + z * z
    return (1.0 + r2 / 0.04) ** -2.5


CONTINUUM_CASES = {
    "uniform": (_uniform, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 8 ** 4, 64),
    "peaked": (_peaked, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 100000, 64),
    "plummer": (_plummer, (-1.0, -1.0, -1.0), (2.0, 2.0, 2.0), 200000, 32),
}


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
@pytest.mark.parametrize("case", sorted(CONTINUUM_CASES))
def test_continuum_octree_matches_jax(case, curve):
    rho, lo, lengths, n, bucket = CONTINUUM_CASES[case]
    tree, counts = tcont.compute_continuum_octree(rho, lo, lengths, n, bucket, curve=curve,
                                                  device="cpu")
    jtree, jcounts = jcont.compute_continuum_octree(rho, lo, lengths, n, bucket, curve=curve)
    _same(tree, jtree)
    _same(counts, jcounts)
    if case != "uniform":
        levels = tcs.node_levels(tree)
        assert levels.max() - levels.min() >= 2


def test_continuum_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcont.compute_continuum_octree(_uniform, (0.0,) * 3, (1.0,) * 3, 512, 64)


# ---------------------------------------------------------------------------
# the gravity tree and the device pyramid
# ---------------------------------------------------------------------------


def _port_keys(x, y, z, box, curve="hilbert"):
    from sphexa_torch.sfc.keys import compute_sfc_keys

    return compute_sfc_keys(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(z), box,
                            curve=curve)


def _sedov_keys():
    from sphexa_torch.init import make_initializer

    s, box, _ = make_initializer("sedov")(16, device="cpu")
    return _port_keys(s.x, s.y, s.z, box)


def _clustered_points():
    from sphexa_torch.init import make_initializer

    rng = np.random.default_rng(7)
    n = 20000
    pts = np.concatenate([rng.uniform(0, 1, (n // 2, 3)),
                          0.5 + 1e-3 * rng.uniform(0, 1, (n // 2, 3))]).astype(np.float32)
    _, box, _ = make_initializer("sedov")(8, device="cpu")
    return _port_keys(pts[:, 0].copy(), pts[:, 1].copy(), pts[:, 2].copy(), box)


def _evrard_wrap_keys():
    from sphexa_torch.init import make_initializer

    s, box, _ = make_initializer("evrard")(12, device="cpu")
    x, y, z = (a.clone() for a in (s.x, s.y, s.z))
    lo, hi = box.lo, box.hi
    x[0], y[0], z[0] = lo
    x[1], y[1], z[1] = hi
    return _port_keys(x, y, z, box)


PYRAMID_CASES = {"sedov16": _sedov_keys, "clustered": _clustered_points,
                 "evrard_wrap": _evrard_wrap_keys}


@pytest.mark.parametrize("case", sorted(PYRAMID_CASES))
@pytest.mark.parametrize("bucket", [16, 64])
def test_pyramid_equals_compute_octree(case, bucket):
    """The device build (unsorted keys) equals the host build of the
    sorted keys bit for bit, and the host build the JAX one."""
    from sphexa_torch.parallel.sizing import leaf_array_from_device_keys

    keys = PYRAMID_CASES[case]()
    host = np.sort(keys.numpy().astype(np.uint64))
    ref, _ = tcs.compute_octree(host, bucket)
    _same(leaf_array_from_device_keys(keys, bucket_size=bucket), ref)
    _same(ref, jcs.compute_octree(host, bucket)[0])


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_build_gravity_tree_matches_jax(curve):
    """Leaves, linkage and geometry of the port's build against the JAX
    build on the same sorted keys."""
    from sphexa_tpu.gravity.tree import build_gravity_tree as jax_build
    from sphexa_torch.gravity.tree import build_gravity_tree

    keys = np.sort(_evrard_wrap_keys().numpy().astype(np.uint64))
    tree, meta = build_gravity_tree(keys, 64, curve=curve, device="cpu")
    jtree, jmeta = jax_build(keys, 64, curve=curve)
    assert (meta.num_leaves, meta.num_nodes, meta.level_ranges) == \
        (jmeta.num_leaves, jmeta.num_nodes, jmeta.level_ranges)
    for f in ("leaf_keys", "parent", "is_leaf", "leaf_of_node", "node_of_leaf",
              "center_frac", "halfsize_frac"):
        np.testing.assert_array_equal(getattr(tree, f).numpy(), np.asarray(getattr(jtree, f)),
                                      err_msg=f)


def test_simulation_tree_equals_build_gravity_tree():
    """The Simulation's tree (the device pyramid and the linkage) equals
    the host build of the same keys: leaves, linkage and meta."""
    from sphexa_torch.gravity.tree import build_gravity_tree
    from sphexa_torch.gravity.traversal import GRAV_BUCKET
    from sphexa_torch.init import make_initializer
    from sphexa_torch.simulation import Simulation

    state, box, const = make_initializer("evrard")(12, overrides={"G": 1.0}, device="cpu")
    sim = Simulation(state, box, const, prop="nbody", device="cpu")
    keys = _port_keys(sim.state.x, sim.state.y, sim.state.z, sim.box, curve=sim.curve)
    tree, meta = build_gravity_tree(torch.sort(keys).values, GRAV_BUCKET, curve=sim.curve,
                                    device="cpu")
    assert sim.cfg.grav_meta == meta
    for f in ("leaf_keys", "parent", "is_leaf", "leaf_of_node", "node_of_leaf",
              "center_frac", "halfsize_frac"):
        assert torch.equal(getattr(sim.gtree, f), getattr(tree, f)), f
