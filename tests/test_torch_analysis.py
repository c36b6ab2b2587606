"""The port's analysis (sphexa_torch/analysis) against the JAX package's:
the four analytic solutions equal on the same radii, the output fields
(``compute_output_fields``, std and VE) against the JAX package's Pallas
branch in interpret mode on the same numpy input, in the caller's
particle order, and the L1 metric.

Tolerances: rho, p and c rtol 1e-5, the density op's Pallas tolerance
(tests/test_pallas_interpret.py:41-52); r, u and |v| are elementwise
float32 arithmetic on the same inputs, rtol 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

from sphexa_tpu.analysis import compare as jax_compare
from sphexa_tpu.analysis import evrard as jax_evrard
from sphexa_tpu.analysis import gresho_chan as jax_gc
from sphexa_tpu.analysis import noh as jax_noh
from sphexa_tpu.analysis import sedov as jax_sedov
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.simulation import make_propagator_config as jax_config

from sphexa_torch.analysis import compute_output_fields, l1_error, output_fields
from sphexa_torch.analysis import evrard, gresho_chan, noh, sedov
from sphexa_torch.convert import state_from_numpy
from sphexa_torch.init import jitter_sedov
from sphexa_torch.simulation import make_propagator_config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_analytic_solutions_equal_jax():
    r = np.random.default_rng(5).uniform(0.0, 0.9, 4000)
    for t in (0.01, 0.05):
        a, b = sedov.sedov_solution(r, time=t), jax_sedov.sedov_solution(r, time=t)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
        a, b = noh.noh_solution(r, time=t * 10), jax_noh.noh_solution(r, time=t * 10)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    for fn in ("gresho_chan_vphi", "gresho_chan_pressure"):
        assert np.array_equal(getattr(gresho_chan, fn)(r), getattr(jax_gc, fn)(r))
    x, y, vx, vy = np.random.default_rng(6).normal(size=(4, 500))
    assert gresho_chan.gresho_chan_l1(x, y, vx, vy) == jax_gc.gresho_chan_l1(x, y, vx, vy)
    assert evrard.evrard_norms() == jax_evrard.evrard_norms()
    fields = {"r": r, "rho": r**2, "u": r + 1.0, "vel": np.sqrt(r)}
    a = evrard.evrard_normalized_profiles(fields, time=0.3)
    b = jax_evrard.evrard_normalized_profiles(fields, time=0.3)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_l1_error_equals_jax():
    rng = np.random.default_rng(1)
    sim, sol = rng.normal(size=(2, 1000)).astype(np.float32)
    assert l1_error(sim, sol) == jax_compare.l1_error(sim, sol)
    assert l1_error(np.ones(4), np.zeros(4)) == 1.0


def _case(side, seed):
    js, jb, jc = jax_init_sedov(side)
    fields = {f.name: np.array(getattr(js, f.name)) for f in dataclasses.fields(js)}
    box = {"lo": np.array(jb.lo), "hi": np.array(jb.hi),
           "boundaries": [int(v) for v in jb.boundaries]}
    fields = jitter_sedov(fields, side, seed)
    fields["temp"] = (fields["temp"] * np.random.default_rng(seed).uniform(
        0.5, 1.5, side**3)).astype(np.float32)
    return fields, box, dataclasses.asdict(jc)


def _jax_state(fields, js_like):
    return dataclasses.replace(js_like, **{k: v for k, v in fields.items()
                                           if k in {f.name for f in dataclasses.fields(js_like)}})


@pytest.mark.parametrize("pipeline", ["std", "ve"])
def test_output_fields_match_jax_pallas(pipeline):
    side = 10
    fields, box, const = _case(side, seed=3)
    # the caller's particle order is not the key order
    perm = np.random.default_rng(4).permutation(side**3)
    shuffled = {k: (v[perm] if np.ndim(v) else v) for k, v in fields.items()}
    js, jb, jc = jax_init_sedov(side)
    jstate = _jax_state(shuffled, js)
    jcfg = jax_config(jstate, jb, jc, backend="pallas")
    want = jax_compare.compute_output_fields(jstate, jb, jcfg, pipeline=pipeline)

    state, tbox, tconst = state_from_numpy(shuffled, box, const, device="cpu")
    cfg = make_propagator_config(state, tbox, tconst)
    got = compute_output_fields(state, tbox, cfg, pipeline=pipeline)
    assert got.keys() == want.keys()
    for k in ("rho", "p", "c"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    for k in ("r", "u", "vel"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0, err_msg=k)

    # the same fields in the unshuffled order, permuted, are the shuffled run's
    base_state, _, _ = state_from_numpy(fields, box, const, device="cpu")
    base = compute_output_fields(base_state, tbox, cfg, pipeline=pipeline)
    for k in got:
        np.testing.assert_allclose(got[k], base[k][perm], rtol=1e-5, atol=0, err_msg=k)


def test_output_fields_resize_an_outgrown_config():
    """A config whose cap no longer covers the state is re-sized for it:
    the fields equal those of a config sized for the state."""
    fields, box, const = _case(8, seed=9)
    state, tbox, tconst = state_from_numpy(fields, box, const, device="cpu")
    cfg = make_propagator_config(state, tbox, tconst)
    want = output_fields(state, tbox, cfg)
    small = dataclasses.replace(cfg, nbr=dataclasses.replace(cfg.nbr, cap=8))
    got = output_fields(state, tbox, small)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    plain = output_fields(state, tbox, cfg, ops="plain")
    for k in want:
        assert torch.equal(plain[k], want[k]), k
