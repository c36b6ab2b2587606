"""Per-stage timing of a step (sphexa_tpu/util/substep_profile.py): the
reference's per-phase Timer printout (main/src/util/timer.hpp:29-82, hook
points ipropagator.hpp:80-87: domain::sync, FindNeighbors, Density, IAD,
MomentumEnergy ... every iteration).

The step runs its stages back to back with no read of the card between
them, so their times do not exist inside it. This module times an
equivalent split execution of the current state, stage by stage, once a
run (``--profile``): each stage ``iters`` times after one warm-up call,
the card synchronized around them (``perf_counter``), so each time is
the stage's own host and device span. The pair ops are the same calls
the step makes: on the card K1's streaming kernels (pair_engine.cu), and
their launches count in ``pair_engine.LAUNCHES`` (1 + ``iters`` per op);
on the CPU their plain versions. The split's sum is an upper bound of
the step's time.

With a telemetry registry every stage time goes out as a
``substep_<stage>`` timing and in one ``phases`` event.
"""

import time
from typing import Dict, Optional

import torch


def _t(fn, *args, iters: int = 3):
    dev = next((a.device for a in args if torch.is_tensor(a)), torch.device("cpu"))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync()
    return out, (time.perf_counter() - t0) / iters


def substep_breakdown(sim, iters: int = 3,
                      telemetry: Optional[object] = None) -> Dict[str, float]:
    """Per-stage wall times (seconds) of one force pass on the current
    state of ``sim``: std (sort, neighbor_prologue, density, eos, iad,
    momentum_energy) and VE (xmass, ve_def_gradh, eos, iad, divv_curlv,
    av_switches, momentum_energy), the JAX function's keys. Other
    propagators, the gather backend and a mesh return {} (the
    per-iteration laps of the --profile series still cover them)."""
    out = _substep_breakdown(sim, iters)
    if telemetry is not None and out:
        telemetry.phases(sim.iteration, {f"substep_{k}": v for k, v in out.items()})
    return out


def _substep_breakdown(sim, iters: int = 3) -> Dict[str, float]:
    from sphexa_torch.propagator import _sort_by_keys
    from sphexa_torch.sfc.box import make_global_box
    from sphexa_torch.sph import pair_engine as pe
    from sphexa_torch.sph.hydro_std import compute_eos_std
    from sphexa_torch.sph.hydro_ve import compute_eos_ve

    cfg = sim.cfg
    if cfg.backend != "pallas" or sim.prop_name not in ("std", "ve") or sim.mesh is not None:
        # the split times the engine's stages; a rank's slab would need the
        # halo exchange between them
        return {}
    const, nbr = cfg.const, cfg.nbr
    box = make_global_box(sim.state.x, sim.state.y, sim.state.z, sim.box)

    out: Dict[str, float] = {}
    (state, keys, _), out["sort"] = _t(lambda s: _sort_by_keys(s, box, cfg.curve), sim.state,
                                       iters=iters)
    x, y, z, h, m = state.x, state.y, state.z, state.h, state.m
    vx, vy, vz = state.vx, state.vy, state.vz

    ranges, out["neighbor_prologue"] = _t(
        lambda *a: pe.group_cell_ranges(*a, box, nbr), x, y, z, h, keys, iters=iters)
    kw = {"ranges": ranges}

    if sim.prop_name == "std":
        (rho, _, _), out["density"] = _t(
            lambda *a: pe.pallas_density(*a, keys, box, const, nbr, **kw), x, y, z, h, m,
            iters=iters)
        (p, c), out["eos"] = _t(lambda t, r: compute_eos_std(t, r, const), state.temp, rho,
                                iters=iters)
        (cs, _), out["iad"] = _t(
            lambda *a: pe.pallas_iad(*a, keys, box, const, nbr, **kw), x, y, z, h, m / rho,
            iters=iters)
        _, out["momentum_energy"] = _t(
            lambda *a: pe.pallas_momentum_energy_std(*a, keys, box, const, nbr, **kw),
            x, y, z, vx, vy, vz, h, m, rho, p, c, *cs, iters=iters)
        return out

    (xm, nc, _), out["xmass"] = _t(
        lambda *a: pe.pallas_xmass(*a, keys, box, const, nbr, **kw), x, y, z, h, m,
        iters=iters)
    ((kx, gradh), _), out["ve_def_gradh"] = _t(
        lambda *a: pe.pallas_ve_def_gradh(*a, keys, box, const, nbr, **kw), x, y, z, h, m, xm,
        iters=iters)
    (prho, c, rho, p), out["eos"] = _t(
        lambda *a: compute_eos_ve(*a, const), state.temp, m, kx, xm, gradh, iters=iters)
    (cs, _), out["iad"] = _t(
        lambda *a: pe.pallas_iad(*a, keys, box, const, nbr, **kw), x, y, z, h, xm / kx,
        iters=iters)
    (dvout, _), out["divv_curlv"] = _t(
        lambda *a: pe.pallas_iad_divv_curlv(*a, keys, box, const, nbr,
                                            with_gradv=cfg.av_clean, **kw),
        x, y, z, vx, vy, vz, h, kx, xm, *cs, iters=iters)
    divv = dvout[0]
    (alpha, _), out["av_switches"] = _t(
        lambda *a: pe.pallas_av_switches(*a, keys, box, state.min_dt, const, nbr, **kw),
        x, y, z, vx, vy, vz, h, c, kx, xm, divv, state.alpha, *cs, iters=iters)
    gradv = tuple(dvout[2:]) if cfg.av_clean else None
    _, out["momentum_energy"] = _t(
        lambda *a: pe.pallas_momentum_energy_ve(*a, keys, box, const, nbr, nc=nc, gradv=gradv,
                                                **kw),
        x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha, *cs, iters=iters)
    return out
