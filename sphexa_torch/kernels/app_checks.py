"""Card checks of the app shell, shared by chip_smoke.py's ``app_shell``
phase and tests/test_torch_gpu.py (``-k app_shell``):

- ``deposit_vs_plain``: the snapshot deposit (observables/snapshot.py,
  ``index_add_`` / ``scatter_reduce_`` on the card) against a plain numpy
  deposit of the same state on the host (``np.add.at`` /
  ``np.maximum.at``): sums within rtol 1e-5 of the grid's max (float32
  adds in another order), a "max" grid exact;
- ``debug_checks_case``: ``Simulation(debug_checks=True)`` on the card, a
  clean step's ``check_error`` "" and a NaN seeded in temp reported with
  its phase and "nan";
- ``substep_launches``: ``substep_breakdown`` on the card with the pair
  engine's launches counted: each K1 streaming op 1 + ``iters`` times;
- ``grid_vs_dump``: a frame's grid against the deposit of the dumped
  particles of the same step (``--ascii`` columns), rtol 1e-6, atol 1e-12.
"""

import dataclasses
from typing import Dict

import numpy as np
import torch

from sphexa_torch.observables.snapshot import SnapshotSpec, snapshot_diagnostics

#: the snapshot deposit's sums against the plain deposit, relative to the
#: grid's largest magnitude (float32 adds of a cell's rows in another order)
DEPOSIT_RTOL = 1e-5


def plain_deposit(state, rho, box, spec: SnapshotSpec) -> np.ndarray:
    """The deposit in numpy on the host, the JAX function's arithmetic in
    float32: the cell of each row, then ``np.add.at`` ("sum") or
    ``np.maximum.at`` ("max", empty cells 0). Returns the (F, G, G) or
    (F, G, G, G) grid."""
    G = spec.grid
    host = {f: (rho if f == "rho" else getattr(state, f)).detach().cpu().numpy()
            for f in spec.fields}
    pos = [getattr(state, a).detach().cpu().numpy() for a in ("x", "y", "z")]
    lo, lengths = box.lo.cpu().numpy(), box.lengths.cpu().numpy()

    def cell(d):
        u = (pos[d] - lo[d]) / lengths[d]
        return np.clip((u * np.float32(G)).astype(np.int32), 0, G - 1).astype(np.int64)

    if spec.volume:
        flat = (cell(0) * G + cell(1)) * G + cell(2)
    else:
        rem = [d for d in (0, 1, 2) if d != spec.axis]
        flat = cell(rem[1]) * G + cell(rem[0])
    cells = G ** (3 if spec.volume else 2)
    out = np.zeros((len(spec.fields), cells), np.float32)
    for k, f in enumerate(spec.fields):
        if spec.reduce == "sum":
            np.add.at(out[k], flat, host[f])
        else:
            row = np.full(cells, np.finfo(np.float32).min, np.float32)
            np.maximum.at(row, flat, host[f])
            out[k] = np.where(row == np.finfo(np.float32).min, 0.0, row)
    return out.reshape(spec.shape)


def deposit_vs_plain(label: str, state, rho, box, spec: SnapshotSpec) -> Dict:
    """The deposit on the state's device against ``plain_deposit``; raises
    past DEPOSIT_RTOL of the grid's max (sums) or on any difference (max).
    Returns max_abs_err, the scale and the grid's total."""
    card = snapshot_diagnostics(state, rho, box, spec)["snap_grid"].cpu().numpy()
    ref = plain_deposit(state, rho, box, spec)
    err = float(np.abs(card.astype(np.float64) - ref).max())
    scale = float(np.abs(ref).max())
    if spec.reduce == "max":
        if not np.array_equal(card, ref):
            raise AssertionError(f"{label}: max deposit differs from plain by {err}")
    elif not err <= DEPOSIT_RTOL * scale:
        raise AssertionError(f"{label}: sum deposit off plain by {err} "
                             f"(limit {DEPOSIT_RTOL} x {scale})")
    return {"max_abs_err": err, "scale": scale, "total": float(ref.astype(np.float64).sum())}


def debug_checks_case(side: int, device) -> Dict:
    """Sedov ``side`` under the debug checks on ``device``: the first
    step is clean (""), and a NaN seeded in temp before the second is
    reported with "nan" and its phase. Returns both messages."""
    from sphexa_torch.init import init_sedov
    from sphexa_torch.simulation import Simulation

    sim = Simulation(*init_sedov(side, device=device), device=device, debug_checks=True)
    clean = sim.step()["check_error"]
    temp = sim.state.temp.clone()
    temp[3] = float("nan")
    sim.state = dataclasses.replace(sim.state, temp=temp)
    seeded = sim.step()["check_error"]
    if clean != "" or "nan" not in seeded or "phase '" not in seeded:
        raise AssertionError(f"debug checks, Sedov {side}: clean {clean!r}, seeded {seeded!r}")
    return {"side": side, "clean": clean, "seeded": seeded}


def substep_launches(sim, iters: int = 3) -> Dict:
    """``substep_breakdown`` of ``sim``'s state with the pair engine's
    launch counts set to 0 just before and read just after: on the card
    every stage's pair op is K1's streaming kernel, 1 + ``iters`` launches
    each (VE's xmass counts under "density"). Returns the stage times in ms
    and the launches."""
    from sphexa_torch.sph import pair_engine as pe
    from sphexa_torch.util.substep_profile import substep_breakdown

    ops = {"std": ("density", "iad", "momentum_energy_std"),
           "ve": ("density", "ve_def_gradh", "iad", "iad_divv_curlv", "av_switches",
                  "momentum_energy_ve")}[sim.prop_name]
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    pe.reset_launches()
    sub = substep_breakdown(sim, iters=iters)
    launches = {k: v for k, v in pe.LAUNCHES.items() if v}
    want = {op: 1 + iters for op in ops} if sim.device.type == "cuda" else {}
    if launches != want:
        raise AssertionError(f"substeps {sim.prop_name}: launches {launches}, expected {want}")
    return {"ms": {k: 1e3 * v for k, v in sub.items()}, "launches": launches}


def grid_vs_dump(label: str, frame: str, dump: str, spec: SnapshotSpec, device) -> Dict:
    """A frame's grid (an ``.npz`` of the ring) against the deposit on
    ``device`` of the particles of an ``--ascii`` dump of the same step
    (the box the frame's): within rtol 1e-6 and atol 1e-12. ``spec``'s
    fields must be state fields (rho is the step's own)."""
    from types import SimpleNamespace

    with np.load(frame) as f:
        grid, lo, lengths = f["grid"], f["lo"], f["lengths"]
    with open(dump) as f:
        names = f.readline().lstrip("#").split()
    cols = dict(zip(names, np.loadtxt(dump, unpack=True)))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    state = SimpleNamespace(**{k: t(cols[k]) for k in ("x", "y", "z", *spec.fields)})
    box = SimpleNamespace(lo=t(lo), lengths=t(lengths))  # what the deposit reads
    one = snapshot_diagnostics(state, state.x, box, spec)["snap_grid"].cpu().numpy()
    if grid.shape != one.shape:
        raise AssertionError(f"{label}: grid {grid.shape} vs {one.shape}")
    np.testing.assert_allclose(grid, one, rtol=1e-6, atol=1e-12, err_msg=label)
    return {"max_abs_err": float(np.abs(grid.astype(np.float64) - one).max()),
            "total": [float(g.sum()) for g in grid], "n": len(cols["x"])}
