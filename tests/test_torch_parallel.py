"""The port's multi-rank path against the JAX package (tests/test_parallel.py
runs the same on its 8-device CPU mesh): gloo ranks on the CPU, spawned per
test (``sphexa_torch.parallel.mesh.spawn``, one torch thread each, the
rendezvous under ``tmp_path``, a join timeout of its own).

- the SFC decomposition (``tree/decomposition.py``) equals the JAX one;
- the distributed sort gives rank k exactly rows [k S, (k + 1) S) of the
  one-device stable sort, keys included, bit for bit, ties too;
- the exchange's pieces equal the JAX package's exactly: the global cell
  table, every rank's coverage bitmap, the sizing's caps, window and need
  matrix, and every group's localized runs (a multiset of (start, len,
  shift)), for both halo modes; one case's caps are partial (max < S);
- one std, one VE and one VE av_clean step, P = 2 and 4, both modes,
  against the JAX package's one-device step (Pallas in interpret mode)
  within tests/test_parallel.py's tolerances (x rtol 1e-5 atol 1e-7, temp
  rtol 1e-4, dt rtol 1e-5), with nc_max, the neighbour total and h (a
  function of each nc alone) exact; the partial-caps case's step against
  the port's one-device step the same way;
- undersized halos trip the escape sentinel (occupancy cap + 1).
"""

import collections
import dataclasses
import functools
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec

from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.parallel import exchange as jex
from sphexa_tpu.parallel import sizing as jsizing
from sphexa_tpu.propagator import _sort_by_keys as jax_sort
from sphexa_tpu.propagator import shard_map, step_hydro_std, step_hydro_ve
from sphexa_tpu.sfc.box import make_global_box as jax_global_box
from sphexa_tpu.sfc.keys import compute_sfc_keys as jax_keys
from sphexa_tpu.simulation import make_propagator_config as jax_config
from sphexa_tpu.sph import pallas_pairs as pp
from sphexa_tpu.tree import decomposition as jdecomp

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.kernels import sharded_checks as sc
from sphexa_torch.parallel.mesh import Mesh, make_sharded_step, spawn
from sphexa_torch.propagator import _step_hydro_std
from sphexa_torch.simulation import make_propagator_config
from sphexa_torch.tree import decomposition

JOIN_TIMEOUT = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ranks(fn, P, tmp_path, *args):
    return spawn(fn, P, args=args, workdir=str(tmp_path), device="cpu", threads=1,
                 timeout=JOIN_TIMEOUT)


def ranks_meanwhile(pool, fn, P, tmp_path, *args):
    """``ranks`` in a thread of ``pool``: the ranks run while this process
    computes the references. Returns the future of their results."""
    return pool.submit(ranks, fn, P, tmp_path, *args)


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def test_decomposition_matches_jax():
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 1 << 30, 5000, dtype=np.int64)).astype(np.uint64)
    for P in (2, 3, 8):
        kb, kc = decomposition.make_sfc_assignment(keys, P, bucket_size=32)
        jb, jc = jdecomp.make_sfc_assignment(keys, P, bucket_size=32)
        np.testing.assert_array_equal(kb, jb)
        np.testing.assert_array_equal(kc, jc)
        assert kc.sum() == keys.shape[0]
    tree = np.array([0, 8, 16, 24, 32], np.uint64)
    np.testing.assert_array_equal(decomposition.uniform_bins(tree, np.array([5, 1, 1, 5]), 2),
                                  jdecomp.uniform_bins(tree, np.array([5, 1, 1, 5]), 2))


@pytest.mark.parametrize("P", [2, 4])
def test_distributed_sort_bitwise(P, tmp_path):
    """Keys with many ties (coarse random keys) and a lattice's Hilbert
    keys: each rank's keys and rows are its slab of the stable sort."""
    rng = np.random.default_rng(P)
    n = 4096
    coarse = rng.integers(0, 64, n).astype(np.int64) << 24
    js, jb, _ = jax_init_sedov(16)
    lattice = np.asarray(jax_keys(js.x, js.y, js.z, jax_global_box(js.x, js.y, js.z, jb)),
                         np.int64)
    cases = [(keys, np.stack([np.arange(n, dtype=np.float32),
                              rng.random(n, dtype=np.float32)], 1))
             for keys in (coarse, lattice)]
    out = ranks(sc.rank_sort, P, tmp_path, cases)
    S = n // P
    for c, (keys, cols) in enumerate(cases):
        order = np.asarray(jnp.argsort(jnp.asarray(keys)))  # stable, as the JAX step sorts
        np.testing.assert_array_equal(order, np.argsort(keys, kind="stable"))
        for k, rank_out in enumerate(out):
            kk, cc = rank_out[c]
            np.testing.assert_array_equal(kk, keys[order][k * S:(k + 1) * S])
            np.testing.assert_array_equal(cc, cols[order][k * S:(k + 1) * S])


# ---------------------------------------------------------------------------
# the exchange against the JAX package's, exactly
# ---------------------------------------------------------------------------

EXCHANGE_SIDE, EXCHANGE_CT = 24, 16


def _jax_exchange(P, caps, wmax):
    """The JAX package's table, coverage and localized runs on a P-device
    submesh of the CPU mesh, from its own sort of the Sedov state."""
    js, jb, jc = jax_init_sedov(EXCHANGE_SIDE)
    cfg = jax_config(js, jb, jc, backend="pallas", cell_target=EXCHANGE_CT)
    gbox = jax_global_box(js.x, js.y, js.z, jb)
    ss, keys, _ = jax_sort(js, gbox, cfg.curve)
    S = js.n // P
    nbr = dataclasses.replace(cfg.nbr, run_cap=min(cfg.nbr.run_cap, S))
    mesh = JaxMesh(np.asarray(jax.devices()[:P]), ("p",))

    def f(keys, x, y, z, h):
        k = jax.lax.axis_index("p")
        table = jex.global_cell_table(keys, nbr.level, "p")
        gr = pp.group_cell_ranges(x, y, z, h, None, gbox, nbr, table=table)
        rs, _, _, cov = jex.localize_ranges_sparse(gr, table, S, P, caps, k, "p")
        rw, _, _ = jex.localize_ranges(gr, S, P, wmax, k, "p")
        runs = lambda r: tuple(a[None] for a in (r.starts, r.lens, r.shift_x, r.shift_y,
                                                 r.shift_z, r.ncells))
        return table, cov[None], runs(rs), runs(rw)

    Pp, Pr = PartitionSpec("p"), PartitionSpec()
    out = jax.jit(shard_map(f, mesh=mesh, in_specs=(Pp,) * 5,
                            out_specs=(Pr, Pp, (Pp,) * 6, (Pp,) * 6), check_vma=False))(
        keys, ss.x, ss.y, ss.z, ss.h)
    return jax.tree.map(np.asarray, out), np.asarray(keys)


def _run_multiset(starts, lens, sx, sy, sz):
    live = lens > 0
    return collections.Counter(zip(starts[live].tolist(), lens[live].tolist(),
                                   sx[live].tolist(), sy[live].tolist(), sz[live].tolist()))


@pytest.mark.parametrize("P", [2, 4])
def test_exchange_matches_jax(P, tmp_path):
    js, jb, jc = jax_init_sedov(EXCHANGE_SIDE)
    with ThreadPoolExecutor(1) as pool:
        future = ranks_meanwhile(pool, sc.rank_exchange, P, tmp_path, _flat(js, jb, jc),
                                 EXCHANGE_CT)
        _check_exchange(P, js, jb, jc, future)


def _check_exchange(P, js, jb, jc, future):
    S = js.n // P

    # the sizing: the caps, the window and the need matrix
    cfg = jax_config(js, jb, jc, backend="pallas", cell_target=EXCHANGE_CT)
    gbox = jax_global_box(js.x, js.y, js.z, jb)
    keys = jax_keys(js.x, js.y, js.z, gbox)
    nbr = dataclasses.replace(cfg.nbr, run_cap=min(cfg.nbr.run_cap, S))
    args = (js.x, js.y, js.z, js.h, keys, gbox, cfg.nbr, P)
    caps = jsizing.device_sparse_halo(*args)
    tight = jsizing.device_sparse_halo(*args, margin=1.0)
    wmax = jsizing.device_halo_window(*args)
    need = np.asarray(jsizing.sparse_need_matrix(js.x, js.y, js.z, js.h, keys, gbox, nbr, P))
    jax_out = _jax_exchange(P, tuple(min(c, S) for c in caps), min(wmax, S))
    out = future.result()
    assert out[0]["nbr"] == {**{k: getattr(cfg.nbr, k) for k in out[0]["nbr"]},
                             "run_cap": min(cfg.nbr.run_cap, S)}
    for o in out:
        assert o["sizes"]["sparse"]["halo_cells"] == caps
        assert o["sizes"]["windowed"]["halo_window"] == wmax
        assert o["tight"]["halo_cells"] == tight
        np.testing.assert_array_equal(o["need"], need)
    # the partial regime: every per-distance cap below a slab
    assert max(tight) < S, (tight, S)

    (table, cov, sparse, windowed), jkeys = jax_out
    for k, o in enumerate(out):
        np.testing.assert_array_equal(o["keys"], jkeys[k * S:(k + 1) * S].astype(np.int64))
        np.testing.assert_array_equal(o["table"], table)
        np.testing.assert_array_equal(o["sparse"]["covered"], cov[k])
        np.testing.assert_array_equal(o["sparse"]["covered_all"], cov)
        for mode, ref in (("sparse", sparse), ("windowed", windowed)):
            mine = o[mode]
            assert not mine["escaped"]
            np.testing.assert_array_equal(mine["ncells"], ref[5][k])
            for g in range(mine["starts"].shape[0]):
                assert _run_multiset(*(mine[f][g] for f in (
                    "starts", "lens", "shift_x", "shift_y", "shift_z"))) == \
                    _run_multiset(*(r[k][g] for r in ref[:5])), (mode, k, g)


# ---------------------------------------------------------------------------
# one sharded step against the JAX package's one-device step
# ---------------------------------------------------------------------------

STEP_SIDE = 12
CASES = [(prop, av_clean, mode) for prop, av_clean in (("std", False), ("ve", False),
                                                         ("ve", True))
         for mode in ("sparse", "windowed")]


@functools.lru_cache(maxsize=None)
def jax_steps():
    """The JAX package's one-device pallas steps (interpret mode) of the
    three propagator forms from Sedov 12 (computed once, while the first
    test's ranks run)."""
    js, jb, jc = jax_init_sedov(STEP_SIDE)
    cfg = jax_config(js, jb, jc, backend="pallas")
    out = {}
    for prop, av_clean in (("std", False), ("ve", False), ("ve", True)):
        fn = step_hydro_std if prop == "std" else step_hydro_ve
        s, _, d = fn(js, jb, dataclasses.replace(cfg, av_clean=av_clean))
        out[(prop, av_clean)] = ({f: np.asarray(getattr(s, f)) for f in sc.SLAB_FIELDS},
                                 {k: np.asarray(v) for k, v in d.items()})
    return cfg, out


def _check_step(name, got, ref_fields, ref_diag, nc_sum=None):
    """tests/test_parallel.py's tolerances, with the neighbour counts exact."""
    np.testing.assert_allclose(got["x"], ref_fields["x"], rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(got["temp"], ref_fields["temp"], rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(got["dt"], float(ref_diag["dt"]), rtol=1e-5, err_msg=name)
    assert got["nc_max"] == int(ref_diag["nc_max"]), name
    # h follows each particle's nc alone (update_h): equal h, equal counts
    np.testing.assert_array_equal(got["h"], ref_fields["h"], err_msg=name)
    if nc_sum is not None:
        assert got["nc_sum"] == nc_sum, name


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_steps_match_jax(P, tmp_path):
    js, jb, jc = jax_init_sedov(STEP_SIDE)
    with ThreadPoolExecutor(1) as pool:
        future = ranks_meanwhile(pool, sc.rank_steps, P, tmp_path, _flat(js, jb, jc), CASES)
        cfg, ref = jax_steps()
        out = future.result()
    assert out[0]["nbr"] == {k: getattr(cfg.nbr, k) for k in out[0]["nbr"]}
    for case in CASES:
        got = {f: np.concatenate([o[case][f] for o in out]) for f in sc.SLAB_FIELDS}
        for k in ("dt", "nc_sum", "nc_max", "occupancy"):
            assert len({o[case][k] for o in out}) == 1, (case, k)  # replicated scalars
            got[k] = out[0][case][k]
        fields, diag = ref[case[:2]]
        _check_step(f"P={P} {case}", got, fields, diag)
        assert got["occupancy"] <= cfg.nbr.cap
        if case[0] == "ve":
            np.testing.assert_allclose(got["alpha"], fields["alpha"], rtol=1e-4, atol=1e-6)
        trips = out[0][case]["shard_trips"]
        assert trips.shape == (P,) and trips.sum() == 0


def test_partial_caps_step_matches_one_device(tmp_path):
    """Sedov 24 (cell_target 16) over 4 ranks with the sparse caps sized at
    margin 1 (all below a slab) against the port's one-device step."""
    js, jb, jc = jax_init_sedov(EXCHANGE_SIDE)
    flat = _flat(js, jb, jc)
    P, S = 4, js.n // 4
    jcfg = jax_config(js, jb, jc, backend="pallas", cell_target=EXCHANGE_CT)
    gbox = jax_global_box(js.x, js.y, js.z, jb)
    caps = jsizing.device_sparse_halo(js.x, js.y, js.z, js.h,
                                      jax_keys(js.x, js.y, js.z, gbox), gbox, jcfg.nbr, P,
                                      margin=1.0)
    assert max(caps) < S, caps
    with ThreadPoolExecutor(1) as pool:
        future = ranks_meanwhile(pool, sc.rank_steps, P, tmp_path, flat,
                                 [("std", False, "sparse")], EXCHANGE_CT,
                                 {"sparse": {"halo_cells": caps}})
        state, box, const = state_from_numpy(*flat, device="cpu")
        cfg = make_propagator_config(state, box, const, cell_target=EXCHANGE_CT)
        s, _, d = _step_hydro_std(state, box, cfg)
        out = future.result()
    res = [o[("std", False, "sparse")] for o in out]
    assert res[0]["sizes"] == {"halo_cells": caps}
    got = {f: np.concatenate([r[f] for r in res]) for f in sc.SLAB_FIELDS}
    got.update({k: res[0][k] for k in ("dt", "nc_sum", "nc_max")})
    _check_step("partial caps", got, {f: getattr(s, f).numpy() for f in sc.SLAB_FIELDS},
                {k: float(v) for k, v in d.items()}, nc_sum=int(d["nc_sum"]))
    occ = res[0]["shard_occ"]
    assert occ.max() <= 1.0 and occ.min() > 0.5  # the caps are nearly consumed, not blown


def test_undersized_halo_trips_the_sentinel(tmp_path):
    js, jb, jc = jax_init_sedov(STEP_SIDE)
    cases = [("std", False, "sparse"), ("std", False, "windowed")]
    out = ranks(sc.rank_steps, 2, tmp_path, _flat(js, jb, jc), cases, None,
                {"sparse": {"halo_cells": (64,)}, "windowed": {"halo_window": 64}})
    cap = out[0]["nbr"]["cap"]
    for case in cases:
        for o in out:
            assert o[case]["occupancy"] == cap + 1, case
            assert o[case]["shard_trips"].sum() > 0, case


def test_launcher_fails_when_a_rank_fails(tmp_path):
    """A rank that raises fails the launcher (and stops the other rank,
    which waits in a collective) instead of hanging: the launcher raises
    the first rank's error to end, rank 1's own or rank 0's lost peer."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="Process [01] terminated"):
        ranks(sc.rank_fail, 2, tmp_path, 1)
    assert time.monotonic() - t0 < JOIN_TIMEOUT / 2


def test_sharded_step_refuses_the_next_slice():
    """Every step function of the port shards since the slice that brought
    turb-ve, block time steps and N-body to a mesh
    (tests/test_torch_sharded_props.py): each binds the mesh, the block
    time steps with ``cfg.dt_bins`` only; what is still refused is a
    function the propagator does not know and a block-time-step function
    without ``dt_bins`` (or a global one with it)."""
    from sphexa_torch.init import init_sedov
    from sphexa_torch.propagator import (
        _step_hydro_std_blockdt, _step_hydro_std_cooling, _step_hydro_ve,
        _step_hydro_ve_blockdt, _step_nbody, _step_turb_ve,
    )

    state, box, const = init_sedov(8, device="cpu")
    cfg = make_propagator_config(state, box, const)
    bcfg = dataclasses.replace(cfg, dt_bins=2)
    mesh = Mesh(group=None, rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    for fn, c in ((_step_hydro_std, cfg), (_step_hydro_ve, cfg), (_step_turb_ve, cfg),
                  (_step_hydro_std_cooling, cfg), (_step_nbody, cfg),
                  (_step_hydro_std_blockdt, bcfg), (_step_hydro_ve_blockdt, bcfg)):
        step = make_sharded_step(mesh, c, fn)
        assert step.cfg.mesh is mesh and step.cfg.list_slot_cap == 0
    for fn, c in ((_step_nbody, bcfg), (_step_hydro_std_blockdt, cfg)):
        with pytest.raises(ValueError, match="dt_bins"):
            make_sharded_step(mesh, c, fn)
    with pytest.raises(ValueError, match="no step function"):
        make_sharded_step(mesh, cfg, lambda *a: a)
