"""The port's snapshot I/O (sphexa_torch/io, init/file_init.py) against
the JAX package's: a dump written by either package is read by the
other bit for bit (fields, box, constants and attributes), the JAX
package's sharded dumps are reassembled by the port (and a torn or
incomplete one refused), Step#n selection, ASCII columns and the
file-split up-sampling are the JAX package's bit for bit."""

import dataclasses
import json
import os

import h5py
import numpy as np
import pytest
import torch

from sphexa_tpu.init import init_noh as jax_init_noh
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.init.file_init import init_file_split as jax_file_split
from sphexa_tpu.io import snapshot as jax_io
from sphexa_tpu.parallel import make_mesh, shard_state

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.init import init_sedov, make_initializer
from sphexa_torch.init.file_init import (
    init_file_split, init_from_file, looks_like_file, parse_file_spec, parse_split_spec,
)
from sphexa_torch.io import list_steps, read_snapshot, read_snapshot_full, write_ascii
from sphexa_torch.io import snapshot as io
from sphexa_torch.sph.particles import PARTICLE_FIELDS, SCALAR_FIELDS


def _flat(state, box, const):
    fields = {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}
    b = {"lo": np.array(box.lo), "hi": np.array(box.hi),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def _jax_case(init=jax_init_sedov, side=8, **const_kw):
    js, jb, jc = init(side)
    jc = dataclasses.replace(jc, **const_kw)
    rng = np.random.default_rng(side)
    # non-trivial values in every conserved field
    js = dataclasses.replace(js, **{f: np.asarray(getattr(js, f)) + rng.standard_normal(
        js.n).astype(np.float32) * 1e-3 for f in ("vx", "vy", "vz", "du", "du_m1", "alpha")})
    return js, jb, jc


def _assert_state_equal(port_state, jax_state):
    for f in io.CONSERVED_FIELDS + SCALAR_FIELDS:
        np.testing.assert_array_equal(getattr(port_state, f).numpy(),
                                      np.asarray(getattr(jax_state, f)), err_msg=f)
    assert not port_state.temp_lo.any()


def _assert_attrs_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("ext", ["h5", "npz"])
def test_round_trip_bit_for_bit(tmp_path, ext):
    state, box, const = init_sedov(8, device="cpu")
    state = dataclasses.replace(state, ttot=state.ttot + 0.125, vx=state.x * 0.5)
    path = str(tmp_path / f"dump.{ext}")
    rho = torch.linspace(1.0, 2.0, state.n)
    assert io.write_snapshot(path, state, box, const, iteration=7,
                             extra_fields={"rho": rho}) == 0
    state2, box2, const2, extra, attrs = read_snapshot_full(path, device="cpu")
    for f in io.CONSERVED_FIELDS + SCALAR_FIELDS:
        assert torch.equal(getattr(state2, f), getattr(state, f)), f
    assert torch.equal(box2.lo, box.lo) and torch.equal(box2.hi, box.hi)
    assert box2.boundaries == box.boundaries
    assert const2 == const
    assert np.array_equal(extra["rho"], rho.numpy()) and list(extra) == ["rho"]
    assert int(attrs["iteration"]) == 7 and int(attrs["numParticlesGlobal"]) == state.n


@pytest.mark.parametrize("ext", ["h5", "npz"])
def test_jax_dump_restarts_in_the_port(tmp_path, ext):
    js, jb, jc = _jax_case(sym_pairs=False, g=0.25, k_cour=0.3)
    path = str(tmp_path / f"jax.{ext}")
    rho = np.arange(js.n, dtype=np.float32)
    jax_io.write_snapshot(path, js, jb, jc, iteration=11, extra_fields={"rho": rho},
                          case="sedov", case_settings={"width": 0.2})
    state, box, const, extra, attrs = read_snapshot_full(path, device="cpu")
    js2, jb2, jc2, jextra, jattrs = jax_io.read_snapshot_full(path)
    _assert_state_equal(state, js2)
    np.testing.assert_array_equal(box.lo.numpy(), np.asarray(jb2.lo))
    np.testing.assert_array_equal(box.hi.numpy(), np.asarray(jb2.hi))
    assert [int(b) for b in box.boundaries] == [int(b) for b in jb2.boundaries]
    assert dataclasses.asdict(const) == dataclasses.asdict(jc2)
    assert const.sym_pairs is False and const.g == 0.25
    np.testing.assert_array_equal(extra["rho"], jextra["rho"])
    _assert_attrs_equal(attrs, jattrs)
    assert json.loads(np.asarray(attrs["caseSettings"]).item().decode()) == {"width": 0.2}


@pytest.mark.parametrize("ext", ["h5", "npz"])
def test_port_dump_restarts_in_the_jax_package(tmp_path, ext):
    js, jb, jc = _jax_case(init=jax_init_noh, side=10, sym_pairs=False)
    state, box, const = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    p_port, p_jax = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    extra = {"rho": np.linspace(0.0, 1.0, js.n, dtype=np.float32)}
    for write, p, s, b, c in ((io.write_snapshot, p_port, state, box, const),
                              (jax_io.write_snapshot, p_jax, js, jb, jc)):
        write(p, s, b, c, iteration=3, extra_fields=extra, case="noh",
              case_settings={"r1": 0.5})
    js2, jb2, jc2, jextra, jattrs = jax_io.read_snapshot_full(p_port)
    for f in io.CONSERVED_FIELDS + SCALAR_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js2, f)), np.asarray(getattr(js, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(jb2.lo), np.asarray(jb.lo))
    assert jb2.boundaries == jb.boundaries and jc2 == jc
    np.testing.assert_array_equal(jextra["rho"], extra["rho"])
    # the same datasets and attributes, names, dtypes and values, as the
    # JAX package writes them
    f_port, a_port = io._read_raw(p_port, -1)
    f_jax, a_jax = io._read_raw(p_jax, -1)
    _assert_attrs_equal(f_port, f_jax)
    _assert_attrs_equal(a_port, a_jax)


def test_sharded_jax_dump_reassembled(tmp_path):
    js, jb, jc = jax_init_sedov(16)  # 4096 = 8 x 512
    sstate = shard_state(js, make_mesh(8))
    path = str(tmp_path / "dump.h5")
    rho = np.arange(js.n, dtype=np.float32)
    tbl = np.asarray([1.0, 2.0, 3.0], np.float32)  # a global table: part 0 only
    for it in (1, 2):
        jax_io.write_snapshot_sharded(path, sstate, jb, jc, iteration=it,
                                      extra_fields={"rho": rho, "modes": tbl}, case="sedov")
    assert not os.path.exists(path) and len(io._find_parts(path)) == 8
    assert looks_like_file(path) and looks_like_file(f"{path}:0")
    state, box, const, extra, attrs = read_snapshot_full(path, device="cpu")
    js2, _, jc2, jextra, jattrs = jax_io.read_snapshot_full(path)
    _assert_state_equal(state, js2)
    assert dataclasses.asdict(const) == dataclasses.asdict(jc2)
    np.testing.assert_array_equal(extra["rho"], rho)
    np.testing.assert_array_equal(extra["modes"], tbl)
    _assert_attrs_equal(attrs, jattrs)
    assert int(attrs["iteration"]) == 2 and list_steps(path) == [0, 1]

    # a torn dump (part 0 a step ahead): the extra step is neither listed
    # nor readable, and -1 is the newest complete one
    parts = io._find_parts(path)
    with h5py.File(parts[0], "a") as f:
        f.copy("Step#1", "Step#2")
    assert list_steps(path) == jax_io.list_steps(path) == [0, 1]
    assert int(io.read_step_attrs(path, -1)["iteration"]) == 2
    with pytest.raises(ValueError, match="not in"):
        read_snapshot(path, step=2, device="cpu")
    # parts resolving to different iterations
    with h5py.File(parts[3], "a") as f:
        f["Step#1"].attrs["iteration"] = np.int64(9)
    with pytest.raises(ValueError, match="torn sharded dump"):
        read_snapshot(path, step=1, device="cpu")
    read_snapshot(path, step=0, device="cpu")
    # an incomplete part set
    os.remove(parts[5])
    with pytest.raises(ValueError, match="7 part files"):
        read_snapshot(path, step=0, device="cpu")


def test_step_selection(tmp_path):
    state, box, const = init_sedov(6, device="cpu")
    path = str(tmp_path / "dump.h5")
    for i in range(3):
        si = dataclasses.replace(state, ttot=state.ttot + i)
        assert io.write_snapshot(path, si, box, const, iteration=10 + i) == i
    assert list_steps(path) == [0, 1, 2]
    for step, want in ((1, 1.0), (-1, 2.0), (-3, 0.0), (0, 0.0)):
        s, *_ = read_snapshot(path, step=step, device="cpu")
        assert float(s.ttot) == float(state.ttot + want)
    for bad in (9, -9):
        with pytest.raises(ValueError):
            read_snapshot(path, step=bad, device="cpu")
        with pytest.raises(ValueError):
            io.read_step_attrs(path, step=bad)
    s, *_ = init_from_file(f"{path}:-2", device="cpu")
    assert float(s.ttot) == float(state.ttot + 1)
    assert parse_file_spec("dump.h5") == ("dump.h5", -1)
    assert parse_file_spec("dump.h5:5") == ("dump.h5", 5)
    assert parse_file_spec("dump.h5:-2") == ("dump.h5", -2)
    assert parse_file_spec("a:b/dump.h5") == ("a:b/dump.h5", -1)
    assert parse_split_spec("dump.h5,4") == ("dump.h5", 4)
    assert parse_split_spec("dump.h5") is None and parse_split_spec("dump.h5,0") is None

    npz = str(tmp_path / "dump.npz")
    io.write_snapshot(npz, state, box, const)
    assert list_steps(npz) == [0]
    read_snapshot(npz, step=0, device="cpu")
    read_snapshot(npz, step=-1, device="cpu")
    with pytest.raises(ValueError):
        read_snapshot(npz, step=3, device="cpu")


def test_step_attrs_extra_fields_and_sym_pairs(tmp_path):
    state, box, const = init_sedov(6, device="cpu")
    path = str(tmp_path / "dump.h5")
    io.write_snapshot(path, state, box, const, iteration=42, case="sedov")
    attrs = io.read_step_attrs(path)
    assert int(attrs["iteration"]) == 42
    assert float(attrs["gamma"]) == pytest.approx(const.gamma)
    assert np.asarray(attrs["initCase"]).item().decode() == "sedov"
    assert set(attrs) == set(jax_io.read_step_attrs(path))
    rho = np.full(state.n, 1.5, np.float32)
    io.write_snapshot(path, state, box, dataclasses.replace(const, sym_pairs=False),
                      extra_fields={"rho": rho})
    _, _, c2, extra = read_snapshot(path, device="cpu")
    np.testing.assert_array_equal(extra["rho"], rho)
    assert c2.sym_pairs is False
    assert jax_io.read_snapshot(path)[2].sym_pairs is False
    _, _, c1, extra0 = read_snapshot(path, step=0, device="cpu")
    assert c1.sym_pairs is True and extra0 == {}
    bad = str(tmp_path / "partial.npz")
    np.savez(bad, field_x=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="not restartable"):
        read_snapshot(bad, device="cpu")


def test_write_ascii_matches_jax(tmp_path):
    js, jb, jc = _jax_case(side=5)
    state, _, _ = state_from_numpy(*_flat(js, jb, jc), device="cpu")
    cols_np = {f: np.asarray(getattr(js, f)) for f in ("x", "y", "z", "temp")}
    cols_np["rho"] = np.linspace(0.5, 1.5, js.n, dtype=np.float32)
    cols_t = {f: getattr(state, f) for f in ("x", "y", "z", "temp")}
    cols_t["rho"] = torch.as_tensor(cols_np["rho"])
    write_ascii(str(tmp_path / "port.txt"), cols_t)
    jax_io.write_ascii(str(tmp_path / "jax.txt"), cols_np)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("init,side,splits", [(jax_init_sedov, 6, 3), (jax_init_noh, 8, 2)])
def test_file_split_matches_jax(tmp_path, init, side, splits):
    js, jb, jc = init(side)
    path = str(tmp_path / "dump.h5")
    jax_io.write_snapshot(path, js, jb, jc, iteration=4)
    ps, pb, pc = init_file_split(path, splits, device="cpu")
    ks, kb, kc = jax_file_split(path, splits)
    assert ps.n == js.n * splits
    for f in PARTICLE_FIELDS + SCALAR_FIELDS:
        np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(ks, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(pb.lo.numpy(), np.asarray(kb.lo))
    assert dataclasses.asdict(pc) == dataclasses.asdict(kc)
    via_factory = make_initializer(f"{path},{splits}")(None, device="cpu")[0]
    assert torch.equal(via_factory.x, ps.x)
    with pytest.raises(ValueError, match="positive"):
        init_file_split(path, 0, device="cpu")


def test_make_initializer_forms(tmp_path):
    state, box, const = init_sedov(6, device="cpu")
    path = str(tmp_path / "dump.h5")
    io.write_snapshot(path, state, box, const)
    s2, b2, _ = make_initializer(f"{path}:0")(None, device="cpu")
    assert torch.equal(s2.x, state.x) and b2.boundaries == box.boundaries
    settings = tmp_path / "s.json"
    settings.write_text(json.dumps({"width": 0.2}))
    s3, _, _ = make_initializer(f"sedov:{settings}")(6, device="cpu")
    assert not torch.equal(s3.temp, state.temp)
    (tmp_path / "bad.json").write_text("[1]")
    with pytest.raises(ValueError, match="JSON object"):
        make_initializer(f"sedov:{tmp_path / 'bad.json'}")
    s4, b4, _ = make_initializer("kelvin-helmholtz")(12, device="cpu")
    assert s4.n > 0 and float(b4.hi[2]) == np.float32(0.0625)
    with pytest.raises(ValueError, match="unknown test case 'plummer'"):
        make_initializer("plummer")


def test_reads_onto_the_card_by_default(tmp_path):
    """A restart reads onto the card unless device="cpu" is given; without
    a card it raises instead of reading onto the CPU."""
    state, box, const = init_sedov(4, device="cpu")
    path = str(tmp_path / "dump.npz")
    io.write_snapshot(path, state, box, const)
    if torch.cuda.is_available():
        assert read_snapshot(path)[0].x.is_cuda
    else:
        for fn in (lambda: read_snapshot(path), lambda: init_from_file(path),
                   lambda: init_file_split(path, 2)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()
