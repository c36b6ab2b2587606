"""The one module of the benchmark that imports the port (sphexa_torch):
the system under test, built as the CLI ``python -m sphexa_torch.app.main``
builds it for the configuration, and the views of its state that the
reference reads to judge it. Nothing here imports JAX or sphexa_tpu."""

from typing import Dict

import numpy as np
import torch

#: per-particle fields of the port's ParticleState, and its 0-d scalars
PARTICLE_FIELDS = ("x", "y", "z", "x_m1", "y_m1", "z_m1", "vx", "vy", "vz",
                   "h", "m", "temp", "temp_lo", "du", "du_m1", "alpha")
SCALAR_FIELDS = ("ttot", "min_dt", "min_dt_m1")


def make_inputs(ic: dict, cfg: dict, device):
    """The port's (ParticleState, Box, SimConstants) from the harness's
    initial conditions: the arrays as they are, x_m1 = v * minDt, the
    constants of the configuration file."""
    from sphexa_torch.sfc.box import BoundaryType, Box
    from sphexa_torch.sph.particles import ParticleState, SimConstants

    f = ic["fields"]
    n = f["x"].shape[0]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def s(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    min_dt = ic["scalars"]["min_dt"]
    zeros = torch.zeros(n, dtype=torch.float32, device=device)
    vx, vy, vz = t(f["vx"]), t(f["vy"]), t(f["vz"])
    state = ParticleState(
        x=t(f["x"]), y=t(f["y"]), z=t(f["z"]),
        x_m1=vx * min_dt, y_m1=vy * min_dt, z_m1=vz * min_dt, vx=vx, vy=vy, vz=vz,
        h=t(f["h"]), m=t(f["m"]), temp=t(f["temp"]), temp_lo=zeros, du=zeros.clone(),
        du_m1=zeros.clone(), alpha=t(f["alpha"]), ttot=s(0.0), min_dt=s(min_dt),
        min_dt_m1=s(ic["scalars"]["min_dt_m1"]))
    b = ic["box"]
    box = Box.create(b["lo"][0], b["hi"][0], b["lo"][1], b["hi"][1], b["lo"][2], b["hi"][2],
                     boundary=tuple(BoundaryType.periodic if p else BoundaryType.open
                                    for p in b["periodic"]), device=device)
    st, c, k = cfg["settings"], cfg["constants"], cfg["kernel"]
    const = SimConstants(ng0=int(st["ng0"]), ngmax=int(st["ngmax"]), gamma=st["gamma"],
                         mui=st["mui"], g=st["gravConstant"], sinc_index=k["sinc_index"],
                         kernel_choice=k["choice"], **c).normalized()
    return state, box, const


def make_simulation(ic: dict, cfg: dict, mix: dict, device):
    """``Simulation`` as the CLI constructs it: the science ledger on (the
    case's ObservableSpec), ``science_rows``, no tuning table, the mix's
    check window and list mode; telemetry with no sink."""
    from sphexa_torch.observables import make_observable_spec
    from sphexa_torch.simulation import Simulation
    from sphexa_torch.telemetry import Telemetry

    state, box, const = make_inputs(ic, cfg, device)
    return Simulation(state, box, const, prop=cfg["prop"], device=device,
                      check_every=mix.get("check_every"), use_lists=mix.get("use_lists", True),
                      obs_spec=make_observable_spec(cfg["init"]),
                      telemetry=Telemetry(sinks=[]), science_rows=True,
                      theta=cfg.get("theta", 0.5), backend="auto", tuned=None,
                      workload=cfg["init"])


def snapshot(sim) -> Dict[str, torch.Tensor]:
    """References to the state the simulation holds now (no copy: the
    port's steps build new tensors and never write a state in place)."""
    s = sim.state
    return {f: getattr(s, f) for f in PARTICLE_FIELDS + SCALAR_FIELDS}


def to_host(snap: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A snapshot copied to numpy (float32 as the port holds it)."""
    return {k: v.detach().cpu().numpy().copy() for k, v in snap.items()}
