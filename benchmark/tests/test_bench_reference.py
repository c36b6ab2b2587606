"""The plain reference (benchmark/reference) against the port on the CPU,
at small sizes: one step from the harness's initial conditions, and the
last of several steps from the state the port held. Every number must
sit within float32's reach of the reference; the bfloat16 control must
not."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness, inits, program
from benchmark.reference import check

CASES = [("sedov-std-100", 12, 1), ("sedov-std-100", 16, 4), ("evrard-ve-125", 16, 1),
         ("evrard-ve-125", 16, 3)]
#: float32 agreement, far under the cells' limits and the control's readings
CLOSE = {"unmatched": 0, "nc_mismatch": 0.0, "dt_gap": 1e-6, "x_gap": 2e-3, "v_gap": 2e-3,
         "du_gap": 1e-4, "temp_gap": 1e-4, "alpha_gap": 1e-4, "ecin_gap": 1e-5,
         "eint_gap": 1e-6, "etot_gap": 1e-6, "linmom_gap": 1e-6, "egrav_gap": 1e-4,
         "grav_gap": 1e-3, "grav_gap99": 3e-3, "x_gap_top": 2e-3, "v_gap_top": 2e-3}
#: with gravity the velocities carry the tree's error (theta 0.5) against
#: the direct sum, and the total energy that of egrav
CLOSE_GRAV = {**CLOSE, "ecin_gap": 1e-4, "linmom_gap": 1e-4, "etot_gap": 1e-4}


def _cfg(name, side):
    cfg = harness.load_json(os.path.join(harness.BENCH, "configs", f"{name}.json"))
    return {**cfg, "side": side}


@pytest.mark.parametrize("name,side,steps", CASES)
def test_reference_follows_the_port(name, side, steps):
    rd = _port_readings(name, side, steps, 2**31 + side + steps)
    close = CLOSE_GRAV if name.startswith("evrard") else CLOSE
    for key, lim in close.items():
        if key in rd:
            assert rd[key] <= lim, (key, rd[key])
    assert rd["pairs"] > 50 * rd["n"]


@pytest.mark.parametrize("seed", [1, 2**31 + 2])
def test_sampled_gravity_follows_the_port(seed, monkeypatch):
    """The cells' gravity path at a small size: the direct sum on a uniform
    sample and the top rows only, the kinetic sums by the difference
    estimate (egrav, and etot with it, carry the small sample's error and
    are held above)."""
    monkeypatch.setattr(check, "GRAV_SAMPLE", 512)
    monkeypatch.setattr(check, "GRAV_TOP", 128)
    rd = _port_readings("evrard-ve-125", 16, 2, seed)
    assert rd["egrav_stderr"] > 0
    for key in ("x_gap", "v_gap", "x_gap_top", "v_gap_top", "ecin_gap", "linmom_gap",
                "grav_gap", "grav_gap99"):
        assert 0 < rd[key] <= CLOSE_GRAV[key], (key, rd[key])


def _port_readings(name, side, steps, seed):
    """The readings of the port's ``steps``-th step against the reference
    (with the particle count under ``n``)."""
    torch.manual_seed(0)
    cfg = _cfg(name, side)
    ic = inits.make(cfg, seed)
    sim = program.make_simulation(ic, cfg, {"check_every": 1, "use_lists": True}, "cpu")
    prev = harness.initial_state(ic)
    for k in range(steps):
        if k:
            prev = program.to_host(program.snapshot(sim))
        sim.step()
        row = sim.drain_science()[-1]
    out = program.to_host(program.snapshot(sim))
    rd = check.readings(prev, out, row, cfg, ic["box"], seed, "cpu")
    return {**rd, "n": len(prev["x"])}


@pytest.mark.parametrize("name,side", [("sedov-std-100", 12), ("evrard-ve-125", 16)])
def test_bfloat16_control_fails_the_limits(name, side):
    """The control, the reference in bfloat16 in the program's place, is
    not correct by the cell's limits, on three seeds."""
    cfg = _cfg(name, side)
    limits = harness.load_json(os.path.join(harness.BENCH, "limits", f"{name}.json"))
    for seed in (3, 2**31 + 11, -5):
        ic = inits.make(cfg, seed)
        prev = harness.initial_state(ic)
        rd = check.readings(prev, None, None, cfg, ic["box"], seed, "cpu", control=True)
        ok, rows = check.judge(rd, limits["first"])
        assert not ok
        assert rd["unmatched"] > 0 and rd["dt_gap"] > limits["first"]["dt_gap"]


def test_initial_conditions_repeat_from_the_seed():
    cfg = _cfg("evrard-ve-125", 16)
    a, b = inits.make(cfg, 2**31 + 3), inits.make(cfg, 2**31 + 3)
    c = inits.make(cfg, 2**31 + 4)
    assert all(np.array_equal(a["fields"][k], b["fields"][k]) for k in a["fields"])
    assert not np.array_equal(a["fields"]["x"], c["fields"]["x"])


def test_match_rows_finds_a_permutation_and_refuses_a_duplicate():
    g = np.random.default_rng(1)
    pos = torch.as_tensor(g.uniform(-0.5, 0.5, (500, 3)))
    disp = torch.as_tensor(g.normal(0.0, 1e-4, (500, 3)))
    h = torch.full((500,), 0.05, dtype=torch.float64)
    perm = torch.randperm(500)
    box = ([-0.5] * 3, [1.0] * 3, [True] * 3)
    src, bad = check.match_rows((pos + disp)[perm], disp[perm], h, pos, box)
    assert bad == 0 and torch.equal(src, perm)
    dup = perm.clone()
    dup[0] = dup[1]
    src, bad = check.match_rows((pos + disp)[dup], disp[dup], h, pos, box)
    assert bad == 2 and int((src < 0).sum()) == 2


def test_limits_name_only_readings_the_reference_gives():
    for name in ("sedov-std-100", "evrard-ve-125"):
        limits = json.load(open(os.path.join(harness.BENCH, "limits", f"{name}.json")))
        assert set(limits) == {"first", "last"}
        keys = set(CLOSE)
        assert set(limits["first"]) <= keys and set(limits["last"]) <= keys
