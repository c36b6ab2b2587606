"""Checks of the turb-ve and std-cooling paths that chip_smoke.py (phases
``turb_cooling_vs_cpu`` and ``turb_path``), tests/test_torch_gpu.py and
the CPU tests share, on the card or the CPU. Any failed check raises.

- ``aux_slice_vs_cpu``: Simulation steps of turb-ve or std-cooling on
  ``device`` against the same steps on the CPU, every step from the same
  input (particles and aux state), with the stated tolerances.
- ``turb_restart``: a turb-ve run dumped (``.npz``, the output fields and
  the stirring state, as the CLI writes them) at one step, read back bit
  for bit, restarted beside the unbroken run (the first restarted step
  to the restart contract, the key bit for bit), and the CLI restarted
  from the dump in a process of its own.

Tolerances (tests/test_torch_turbulence.py and tests/test_torch_cooling.py
derive them): the fields of a std step rtol 1e-4 and of a VE step 2e-4,
atol 5e-6 x max|.|; neighbour counts exact; dt rel 1e-4 (the cooling time
and the acceleration condition are reductions of rates); the stirring's
key bit for bit and its phases atol 5e-5 x max|phase| (the OU damping
sqrt(1 - f^2) with f within 1e-4 of 1 magnifies an ulp of f); the
cooling source du (and du_m1) within 2 ulp of max u over dt (it is
(u' - u) / dt, whose float32 precision is an ulp of u over dt); the
chemistry, permuted exactly where the CIE table passes it through,
rel 1e-5 / atol 1e-6 where the network evolves it.
"""

import os
import time

import numpy as np
import torch

from sphexa_torch.analysis import output_fields
from sphexa_torch.init import init_evrard_cooling, init_turbulence
from sphexa_torch.io import read_snapshot_full, write_snapshot
from sphexa_torch.io.snapshot import CONSERVED_FIELDS
from sphexa_torch.kernels.io_checks import cli_restart
from sphexa_torch.observables import make_observable_spec
from sphexa_torch.physics.cooling import CHEM_FIELDS, CoolingConfig
from sphexa_torch.simulation import Simulation
from sphexa_torch.sph.hydro_turb import (
    turbulence_state_from_fields, turbulence_state_to_fields,
)
from sphexa_torch.sph.particles import SCALAR_FIELDS

INITS = {"turbulence": init_turbulence, "evrard-cooling": init_evrard_cooling}

#: the phases' tolerance over their largest magnitude
PHASES_ATOL = 5e-5


def _phases_err(a, b) -> float:
    """max |a - b| of two phase tensors over max |b|; raises past PHASES_ATOL."""
    b = b.cpu()
    err = float((a.cpu() - b).abs().max() / b.abs().max())
    if not err <= PHASES_ATOL:
        raise AssertionError(f"stirring phases off by {err} of their scale")
    return err


def aux_slice_vs_cpu(prop: str, case: str, side: int, steps: int, device="cuda",
                     overrides=None, evolve: bool = False, use_lists: bool = True,
                     cell_target=None) -> dict:
    """``steps`` steps of Simulation(prop) on ``case`` at ``side`` on
    ``device`` against the same steps on the CPU, each from the device
    run's input (particles, box and the aux state). With lists each side
    builds its own on the first step (equal: the same sorted state) and
    both freeze the same order. Returns the worst errors."""
    kw = {"prop": prop, "use_lists": use_lists, "cell_target": cell_target,
          "obs_spec": make_observable_spec(case)}
    if prop == "std-cooling":
        const = INITS[case](side, overrides=overrides, device="cpu")[2]
        kw["cooling_cfg"] = CoolingConfig(gamma=const.gamma, evolve_species=evolve)
    dev = Simulation(*INITS[case](side, overrides=overrides, device=device), device=device,
                     **kw)
    cpu = Simulation(*INITS[case](side, overrides=overrides, device="cpu"), device="cpu", **kw)
    rtol = 1e-4 if prop == "std-cooling" else 2e-4
    eps = float(np.finfo(np.float32).eps)
    worst = {"fields": 0.0, "du": 0.0, "phases": 0.0, "chem": 0.0, "dt": 0.0}
    for it in range(steps):
        cpu.state, cpu.box = dev.state.to("cpu"), dev.box.to("cpu")
        if prop == "turb-ve":
            cpu.turb_state = dev.turb_state.to("cpu")
        else:
            cpu.chem = dev.chem.to("cpu")
        u_max = dev.const.cv * float(dev.state.temp.max())
        dd, dc = dev.step(), cpu.step()
        label = f"{prop} {case} {side} step {it}"
        for k in ("nc_max", "nc_sum", "occupancy", "use_lists"):
            if dd[k] != dc[k]:
                raise AssertionError(f"{label}: {k} {dd[k]} vs cpu {dc[k]}")
        for k in ("dt",) + (("dt_cool",) if prop == "std-cooling" else ()) + (
                ("egrav",) if dev.gravity_on else ()):
            err = abs(dd[k] - dc[k]) / abs(dc[k])
            if not err <= 1e-4:
                raise AssertionError(f"{label}: {k} {dd[k]} vs cpu {dc[k]}")
            worst["dt"] = max(worst["dt"], err)
        du_atol = 2.0 * eps * u_max / dc["dt"]
        for f in ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "du", "du_m1", "alpha"):
            a, b = getattr(dev.state, f).cpu(), getattr(cpu.state, f)
            if prop == "std-cooling" and f in ("du", "du_m1"):
                torch.testing.assert_close(a, b, rtol=0.0, atol=du_atol, msg=f"{label}: {f}")
                worst["du"] = max(worst["du"], float((a - b).abs().max()) / du_atol)
                continue
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=rtol, atol=5e-6 * scale, msg=f"{label}: {f}")
            worst["fields"] = max(worst["fields"], float((a - b).abs().max()) / (scale or 1.0))
        if prop == "turb-ve":
            if not np.array_equal(dev.turb_state.key, cpu.turb_state.key):
                raise AssertionError(f"{label}: stirring keys differ")
            worst["phases"] = max(worst["phases"], _phases_err(dev.turb_state.phases,
                                                               cpu.turb_state.phases))
            continue
        for k in CHEM_FIELDS:
            a, b = getattr(dev.chem, k).cpu(), getattr(cpu.chem, k)
            if evolve and k != "metal":
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=f"{label}: chem {k}")
                worst["chem"] = max(worst["chem"], float((a - b).abs().max()))
            elif not torch.equal(a, b):
                raise AssertionError(f"{label}: chem {k} permuted differently")
    if use_lists and dev.cfg.list_slot_cap > 0 and dev.lists is None:
        raise AssertionError(f"{prop} {case} {side}: the list-mode run streamed")
    return {"phase": "turb_cooling_vs_cpu", "prop": prop, "case": case, "side": side,
            "n": dev.state.n, "steps": steps, "evolve": evolve, "overrides": overrides,
            "use_lists": dd["use_lists"], "rebuilds": [dev.rebuilds, cpu.rebuilds],
            "worst": worst, "dt_limiter": dd["dt_limiter"],
            "energy_drift": [dev.energy_drift, cpu.energy_drift]}


def turb_restart(side: int, device, dirpath: str, dump_at: int = 2, to_step: int = 4) -> dict:
    """turb-ve on the turbulence case at ``side`` (checked every step, the
    case's observable in the step) to ``dump_at``; the dump the CLI writes
    (``dump_turbulence.npz``: the output fields of the VE estimator and
    the stirring state) read back bit for bit; a run restarted from it
    beside the unbroken one: its first step to the restart contract (dt
    rel 1e-6, x atol 1e-7 order-insensitively: the restart re-sorts, and
    the two-sum carry restarts at zero), the stirring key bit for bit and
    the phases within tolerance, at every step to ``to_step``; then the
    CLI (``--prop turb-ve``) restarted from the dump in a process of its
    own, its constants.txt rows within rel 1e-6 of the unbroken run's
    (time, dt, energies, machRMS). Returns the report with the unbroken
    run's science rows (``rows``)."""
    spec = make_observable_spec("turbulence")
    sim = Simulation(*init_turbulence(side, device=device), prop="turb-ve", device=device,
                     obs_spec=spec, science_rows=True)
    for _ in range(dump_at):
        sim.step()
    fields = {**output_fields(sim.state, sim.box, sim.cfg, "ve"),
              **turbulence_state_to_fields(sim.turb_state, sim.turb_cfg)}
    path = os.path.join(dirpath, "dump_turbulence.npz")
    write_snapshot(path, sim.state, sim.box, sim.const, iteration=sim.iteration,
                   extra_fields=fields, case="turbulence")
    state, box, const, extra, attrs = read_snapshot_full(path, device=device)
    for f in CONSERVED_FIELDS + SCALAR_FIELDS:
        if not torch.equal(getattr(state, f), getattr(sim.state, f)):
            raise AssertionError(f"turb restart: {f} read back differs")
    turb, tcfg = turbulence_state_from_fields(extra, device=device)
    if (tcfg != sim.turb_cfg or not np.array_equal(turb.key, sim.turb_state.key)
            or not torch.equal(turb.phases, sim.turb_state.phases)):
        raise AssertionError("turb restart: the stirring state read back differs")
    rest = Simulation(state, box, const, prop="turb-ve", device=device, obs_spec=spec,
                      turb_state=turb, turb_cfg=tcfg)
    rest.iteration = int(attrs["iteration"])
    first = None
    for _ in range(to_step - dump_at):
        d_orig, d_rest = sim.step(), rest.step()
        x_err = float((torch.sort(rest.state.x).values - torch.sort(sim.state.x).values)
                      .abs().max())
        dt_rel = abs(d_rest["dt"] - d_orig["dt"]) / abs(d_orig["dt"])
        if not np.array_equal(rest.turb_state.key, sim.turb_state.key):
            raise AssertionError("turb restart: the stirring key left the unbroken run's")
        perr = _phases_err(rest.turb_state.phases, sim.turb_state.phases)
        if first is None:
            if not (dt_rel <= 1e-6 and x_err <= 1e-7):
                raise AssertionError(f"turb restart: first step dt rel {dt_rel}, x {x_err} "
                                     "off the unbroken run (limits 1e-6, 1e-7)")
            first = {"dt_rel": dt_rel, "x_max_abs": x_err, "phases_err": perr,
                     "dt_bitwise": d_rest["dt"] == d_orig["dt"]}
    all_rows = sim.drain_science()
    rows = [r for r in all_rows if r["it"] > dump_at]
    t0 = time.perf_counter()
    cli = cli_restart(path, os.path.join(dirpath, "cli"), to_step=to_step, device=device,
                      check_every=1, prop="turb-ve")
    with open(os.path.join(dirpath, "cli", "constants.txt")) as f:
        head = f.readline().split()
        cli_rows = [[float(v) for v in ln.split()] for ln in f if not ln.startswith("#")]
    if head[-1] != "machRMS" or len(cli_rows) != len(rows):
        raise AssertionError(f"turb CLI restart: columns {head}, {len(cli_rows)} rows")
    worst = 0.0
    for r, c in zip(rows, cli_rows):
        want = [r["it"], r["t"], r["dt"], r["etot"], r["ecin"], r["eint"], r["egrav"],
                r["extra"]]
        for a, b in zip(c, want):
            err = abs(a - b) / max(abs(b), 1e-30)
            if not (err <= 1e-6 or abs(a - b) <= 1e-12):
                raise AssertionError(f"turb CLI restart: row {c} vs the unbroken run's {want}")
            worst = max(worst, err if abs(b) > 1e-12 else 0.0)
    return {"n": sim.state.n, "dump_at": dump_at, "to_step": to_step,
            "dump_bytes": os.path.getsize(path), "first_step": first,
            "rebuilds": {"unbroken": sim.rebuilds, "restarted": rest.rebuilds},
            "cli": {**cli, "rows_rel_err": worst, "seconds": time.perf_counter() - t0},
            "lists": sim.lists is not None, "rows": all_rows}
