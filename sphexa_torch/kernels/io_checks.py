"""Checks of snapshots, restart and the output fields that chip_smoke.py
(phase ``io_restart``), tests/test_torch_gpu.py and the CPU tests share,
on the card or the CPU. Any failed check raises.

- ``restart_vs_unbroken``: a list-mode run dumped (``.npz``, with the
  output fields) at one step, read back bit for bit, restarted, and held
  beside the unbroken run: its first step to the JAX package's restart
  contract (tests/test_io.py:131-148: dt within rel 1e-6, x within atol
  1e-7), every field at the end within ``bound`` of its scale. A third
  run made from the unbroken run's state in memory (its lists rebuilt,
  ``temp_lo`` kept) splits the difference between its two causes.
- ``output_fields_vs_plain``: the output fields through the kernel
  wrappers against their plain versions on the same device, rho, p and c
  within rtol 1e-5 (tests/test_pallas_interpret.py:41-52).
- ``l1_reference``: the reference CI's configurations
  (tests/test_l1_reference.py:57-145) and ``l1_misses``, their windows.
- ``cli_restart``: the CLI restarted from a dump in a process of its own,
  its ``constants.txt`` rows and its run directory."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from sphexa_torch.analysis import compute_output_fields, l1_error, output_fields
from sphexa_torch.analysis.noh import noh_solution
from sphexa_torch.analysis.sedov import sedov_solution
from sphexa_torch.init import init_noh, init_sedov
from sphexa_torch.io import read_snapshot_full, write_snapshot
from sphexa_torch.io.snapshot import CONSERVED_FIELDS
from sphexa_torch.observables import conserved_quantities
from sphexa_torch.simulation import Simulation
from sphexa_torch.sph.particles import SCALAR_FIELDS
from sphexa_torch.telemetry import SCHEMA_VERSION

INITS = {"sedov": init_sedov, "noh": init_noh}

#: the evolving fields compared between a restarted run and the unbroken one
EVOLVED = ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "du")

#: restarted run vs the unbroken one, 20 steps after the restart: max over
#: the fields of max |sorted a - sorted b| / max |b|. Measured 7.2e-7 at
#: std Sedov 100^3 from step 20 to 40 on an H100 (the reset two-sum carry
#: 7.1e-7 of it, the list rebuild 4.3e-7); the bound keeps 14x of margin
RESTART_BOUND = 1e-5


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _field_diff(a, b) -> dict:
    """Per field, the largest difference of the sorted values over the
    field's scale: the runs order their particles on their own (a restart
    rebuilds the lists, which re-sorts), so the comparison is
    order-insensitive."""
    out = {}
    for f in EVOLVED:
        x = torch.sort(getattr(a, f).double()).values
        y = torch.sort(getattr(b, f).double()).values
        out[f] = float((x - y).abs().max() / y.abs().max().clamp_min(1e-300))
    return out


def restart_vs_unbroken(case: str, side: int, device, dirpath: str, spec=None,
                        dump_at: int = 20, to_step: int = 40,
                        bound: float = RESTART_BOUND) -> dict:
    """Run ``case`` (std, list mode, checked every step) to ``dump_at``,
    write ``<dirpath>/dump_<case>.npz`` with the output fields, read it
    back onto ``device`` and check it bit for bit; restart from it and
    from the unbroken run's state in memory, and step the three runs to
    ``to_step``. Returns the times (ms), the dump's bytes, the first
    restarted step against the unbroken one, the field differences at
    ``to_step`` (``restart``: dump restart vs unbroken; ``rebuild``:
    in-memory restart vs unbroken, the lists rebuilt; ``temp_lo``: dump
    restart vs in-memory restart, the carry reset), the drifts, and the
    dump's path and restored (state, box, cfg)."""
    sim = Simulation(*INITS[case](side, device=device), prop="std", device=device,
                     obs_spec=spec)
    for _ in range(dump_at):
        sim.step()
    if sim.lists is None:
        raise AssertionError(f"{case} {side}: the run streams; the check needs list mode")
    _sync(device)
    t0 = time.perf_counter()
    fields = output_fields(sim.state, sim.box, sim.cfg)
    _sync(device)
    fields_ms = 1e3 * (time.perf_counter() - t0)
    path = os.path.join(dirpath, f"dump_{case}.npz")
    t0 = time.perf_counter()
    write_snapshot(path, sim.state, sim.box, sim.const, iteration=sim.iteration,
                   extra_fields=fields, case=case)
    dump_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    state, box, const, extra, attrs = read_snapshot_full(path, device=device)
    _sync(device)
    read_ms = 1e3 * (time.perf_counter() - t0)

    for f in CONSERVED_FIELDS + SCALAR_FIELDS:
        if not torch.equal(getattr(state, f), getattr(sim.state, f)):
            raise AssertionError(f"restart: {f} read back differs from the one written")
    if not (torch.equal(box.lo, sim.box.lo) and torch.equal(box.hi, sim.box.hi)
            and box.boundaries == sim.box.boundaries and const == sim.const
            and int(attrs["iteration"]) == sim.iteration):
        raise AssertionError("restart: box, constants or iteration read back differ")
    for k, v in fields.items():
        if not np.array_equal(extra[k], v.cpu().numpy()):
            raise AssertionError(f"restart: output field {k} read back differs")

    fresh = Simulation(sim.state, sim.box, sim.const, prop="std", device=device,
                       obs_spec=spec)
    rest = Simulation(state, box, const, prop="std", device=device, obs_spec=spec)
    fresh.iteration = rest.iteration = int(attrs["iteration"])
    d_orig, d_rest = sim.step(), rest.step()
    fresh.step()
    dt_rel = abs(d_rest["dt"] - d_orig["dt"]) / abs(d_orig["dt"])
    x_err = float((torch.sort(rest.state.x).values - torch.sort(sim.state.x).values)
                  .abs().max())
    if not (dt_rel <= 1e-6 and x_err <= 1e-7):
        raise AssertionError(f"restart: first step dt rel {dt_rel}, x {x_err} off the "
                             "unbroken run (limits 1e-6, 1e-7)")
    for _ in range(to_step - dump_at - 1):
        for s in (sim, rest, fresh):
            s.step()
    diffs = {"restart": _field_diff(rest.state, sim.state),
             "rebuild": _field_diff(fresh.state, sim.state),
             "temp_lo": _field_diff(rest.state, fresh.state)}
    worst = max(diffs["restart"].values())
    if not worst <= bound:
        raise AssertionError(f"restart: step {to_step} fields {diffs['restart']} off the "
                             f"unbroken run (limit {bound} of scale)")
    if rest.iteration != to_step or rest.rebuilds < 1:
        raise AssertionError(f"restart: iteration {rest.iteration}, {rest.rebuilds} builds")
    return {"n": sim.state.n, "dump_at": dump_at, "to_step": to_step,
            "output_fields_ms": fields_ms, "dump_ms": dump_ms, "read_ms": read_ms,
            "dump_bytes": os.path.getsize(path),
            "first_step": {"dt_rel": dt_rel, "x_max_abs": x_err},
            "field_diff": diffs, "worst": worst, "bound": bound,
            "drift": {"unbroken": sim.energy_drift, "restarted": rest.energy_drift,
                      "in_memory": fresh.energy_drift},
            "rebuilds": {"unbroken": sim.rebuilds, "restarted": rest.rebuilds},
            "path": path, "restored": (state, box, sim.cfg)}


def output_fields_vs_plain(name: str, state, box, cfg, pipeline: str) -> dict:
    """The output fields through the kernel wrappers against their plain
    versions on the state's device: rho, p and c within rtol 1e-5; r, u
    and vel (no pair op) equal. Returns each field's max abs error."""
    got = output_fields(state, box, cfg, pipeline)
    want = output_fields(state, box, cfg, pipeline, ops="plain")
    out = {}
    for k in want:
        if k in ("rho", "p", "c"):
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0.0,
                                       msg=f"{name} {pipeline}: {k}")
        elif not torch.equal(got[k], want[k]):
            raise AssertionError(f"{name} {pipeline}: {k} differs")
        out[k] = float((got[k] - want[k]).abs().max())
    return out


#: rho0 of the Noh IC: mTotal = 1 inside the r = 0.5 sphere
NOH_RHO0 = 1.0 / (4.0 * np.pi / 3.0 * 0.5**3)


def l1_reference(case: str, prop: str, side: int, steps: int, device,
                 check_every: int = 10) -> dict:
    """One of the reference CI's runs as tests/test_l1_reference.py makes
    it: ``case`` at ``side``, ``steps`` steps in windows of
    ``check_every``, the drift of ``conserved_quantities`` from the first
    state to the last, the output fields at the end (the std estimator,
    as that test calls it; a VE run also reports the VE estimator's
    L1_rho) against the analytic solution at the reached time. Returns
    the values, the wall time of the steps and the particle-updates/s."""
    state, box, const = INITS[case](side, device=device)
    sim = Simulation(state, box, const, prop=prop, device=device, check_every=check_every)
    e0 = float(conserved_quantities(sim.state, const)["etot"])
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        sim.step()
    sim.flush()
    _sync(device)
    wall = time.perf_counter() - t0
    e1 = float(conserved_quantities(sim.state, const)["etot"])
    fields = compute_output_fields(sim.state, sim.box, sim.cfg)
    t = float(sim.state.ttot)
    out = {"case": case, "prop": prop, "side": side, "n": sim.state.n, "steps": steps,
           "check_every": check_every, "t": t, "wall_s": wall,
           "particle_updates_per_s": sim.state.n * steps / wall,
           "drift": abs(e1 - e0) / max(abs(e0), 1e-30), "rollbacks": sim.rollbacks,
           "rebuilds": sim.rebuilds, "lists": sim.lists is not None}
    if case == "sedov":
        sol = sedov_solution(fields["r"], time=t, eblast=1.0, gamma=const.gamma)
        out.update({k: l1_error(fields[f], sol[f]) for k, f in (
            ("l1_rho", "rho"), ("l1_p", "p"), ("l1_vel", "vel"))})
        if prop == "ve":
            ve = compute_output_fields(sim.state, sim.box, sim.cfg, pipeline="ve")
            out["l1_rho_ve_estimator"] = l1_error(ve["rho"], sol["rho"])
    else:
        sol = noh_solution(fields["r"], time=t, gamma=const.gamma)
        out.update({"l1_raw": l1_error(fields["rho"], sol["rho"]),
                    "l1_norm": l1_error(fields["rho"] / NOH_RHO0, sol["rho"]),
                    "peak_over_jump": float(fields["rho"].max()) / (64.0 * NOH_RHO0)})
    return out


def l1_misses(r: dict) -> list:
    """The windows of tests/test_l1_reference.py that ``r`` misses."""
    if r["case"] == "noh":
        checks = {"l1_raw": 3.0 < r["l1_raw"] < 7.0, "l1_norm": r["l1_norm"] < 2.5,
                  "peak": r["peak_over_jump"] > 0.4, "drift": r["drift"] < 2e-4}
    elif r["prop"] == "ve":
        checks = {"l1_rho": 0.25 < r["l1_rho"] < 0.45, "drift": r["drift"] < 1e-4}
    else:
        checks = {"l1_rho": 0.13 < r["l1_rho"] < 0.20, "l1_p": r["l1_p"] < 0.30,
                  "l1_vel": r["l1_vel"] < 0.20, "drift": r["drift"] < 1e-3}
    return [k for k, ok in checks.items() if not ok]


def cli_restart(dump: str, out_dir: str, to_step: int, device,
                check_every: int = 8, timeout: int = 600, prop: str = "std") -> dict:
    """``python -m sphexa_torch.app.main --init <dump> -s <to_step> -o
    <out_dir> --telemetry-dir <out_dir>/tel --check-every N --prop <prop>``
    in a process of its own, from the repository's root. Checks: ``constants.txt``
    holds the rows after the dump's iteration up to ``to_step``; the
    manifest parses and names the run's device (on the card, the card);
    every event line parses and carries the schema version; the memory
    events carry byte lists (on the card, non-empty); no blackbox."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tel = os.path.join(out_dir, "tel")
    cmd = [sys.executable, "-m", "sphexa_torch.app.main", "--init", dump, "-s", str(to_step),
           "-o", out_dir, "--telemetry-dir", tel, "--check-every", str(check_every),
           "--prop", prop]
    on_card = torch.device(device).type == "cuda"
    if not on_card:
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"CLI restart exited {run.returncode}: {run.stderr[-2000:]}")
    it0 = int(read_snapshot_full(dump, device="cpu")[4]["iteration"])
    with open(os.path.join(out_dir, "constants.txt")) as f:
        rows = [int(float(ln.split()[0])) for ln in f if not ln.startswith("#")]
    if rows != list(range(it0 + 1, to_step + 1)):
        raise AssertionError(f"CLI restart: constants.txt rows {rows}")
    with open(os.path.join(tel, "manifest.json")) as f:
        manifest = json.load(f)
    want_name = torch.cuda.get_device_name(torch.device(device)) if on_card else None
    if manifest["device_name"] != want_name or manifest["backend"] != torch.device(device).type:
        raise AssertionError(f"CLI restart: manifest names {manifest['device_name']} on "
                             f"{manifest['backend']}")
    with open(os.path.join(tel, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    if any(e.get("v") != SCHEMA_VERSION for e in events):
        raise AssertionError("CLI restart: an event without the schema version")
    memory = [e for e in events if e["kind"] == "memory"]
    if not memory or any(bool(e["bytes_in_use"]) != on_card for e in memory):
        raise AssertionError(f"CLI restart: memory events {memory}")
    if os.path.exists(os.path.join(tel, "blackbox.json")):
        raise AssertionError("CLI restart: a blackbox was written")
    return {"seconds": seconds, "rows": [rows[0], rows[-1]], "events": len(events),
            "memory_points": [e["point"] for e in memory],
            "bytes_in_use": memory[-1]["bytes_in_use"], "device_name": manifest["device_name"],
            "windows": sum(e["kind"] == "window" for e in events)}
