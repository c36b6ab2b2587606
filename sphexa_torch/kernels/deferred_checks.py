"""Checks of the deferred check windows (``Simulation(check_every > 1)``)
that chip_smoke.py, tests/test_torch_gpu.py and tests/test_torch_deferred.py
share, on the card or the CPU: a window whose steps overflow (the cap
forced to 8; h grown past the search window) rolls back, re-sizes and
replays to a clean run's state; a deferred streaming run equals the
synchronous one bit for bit; a list-mode window on stale lists rolls back
(``list-expiry``), rebuilds and replays; a happy window reads the card
once. Any disagreement raises."""

import collections
import dataclasses
import os
import warnings

import torch

from sphexa_torch.init import init_noh, init_sedov
from sphexa_torch.observables import ObservableSpec
from sphexa_torch.simulation import Simulation
from sphexa_torch.telemetry import MemorySink, Telemetry

#: fields compared between a replayed run and its reference
FIELDS = ("x", "y", "z", "vx", "vy", "vz", "h", "temp", "du")


def _run(sim: Simulation, steps: int) -> Simulation:
    for _ in range(steps):
        sim.step()
    sim.flush()
    return sim


def _max_rel(name: str, a, b, tols: dict) -> dict:
    """max |a - b| / max(|b|, atol-scale) per field; raises past ``tols``
    (field -> rtol; 0 means equal bit for bit)."""
    out = {}
    for f, rtol in tols.items():
        x, y = getattr(a, f).double().cpu(), getattr(b, f).double().cpu()
        err = float(((x - y).abs() / y.abs().clamp_min(1e-30)).max())
        out[f] = err
        if (rtol == 0 and not torch.equal(x, y)) or err > rtol:
            raise AssertionError(f"{name}: {f} off the reference by rel {err} (limit {rtol})")
    return out


def cap_rollback(side: int, device, window: int = 5) -> dict:
    """Streaming Sedov ``side``, the cap forced to 8 before a window of
    ``window``: the flush finds the overflow, rolls the window back,
    re-sizes and replays it; the state within rel 1e-6 of a clean
    synchronous run (tests/test_simulation_async.py's tolerance)."""
    ref = _run(Simulation(*init_sedov(side, device=device), device=device, use_lists=False),
               window)
    sink = MemorySink()
    sim = Simulation(*init_sedov(side, device=device), device=device, use_lists=False,
                     check_every=window, telemetry=Telemetry(sinks=[sink]))
    sim._cfg = dataclasses.replace(sim._cfg, nbr=dataclasses.replace(sim._cfg.nbr, cap=8))
    deferred = [sim.step().get("deferred") for _ in range(window)]
    rollbacks = sink.of_kind("rollback")
    if (deferred[:-1] != [1.0] * (window - 1) or sim.iteration != window
            or [e["reason"] for e in rollbacks] != ["overflow"] or sim.cfg.nbr.cap <= 8
            or sim.cfg.nbr != ref.cfg.nbr):
        raise AssertionError(f"cap rollback, Sedov {side}: deferred {deferred}, iteration "
                             f"{sim.iteration}, rollbacks {rollbacks}, nbr {sim.cfg.nbr}")
    err = _max_rel(f"cap rollback, Sedov {side}", sim.state, ref.state,
                   {"x": 1e-6, "temp": 1e-6})
    return {"side": side, "window": window, "replays": sim.replays,
            "reconfigures": sim.reconfigures, "max_rel_err": err}


def h_growth_rollback(side: int, device, window: int = 4, cell_target=None,
                      shrink: float = 1.0) -> dict:
    """Streaming Sedov ``side`` configured at h x ``shrink``, then h x 4
    before a window of ``window``: the window's steps run with a search
    window too small (the cap + 1 sentinel), the flush rolls back and
    replays through the checked path, which re-sizes first; the state
    within rel 1e-6 (x) and 1e-5 (temp) of a synchronous run sized for the
    grown h from the start (tests/test_simulation_async.py's tolerances)."""
    state, box, const = init_sedov(side, device=device)
    sink = MemorySink()
    sim = Simulation(dataclasses.replace(state, h=state.h * shrink), box, const,
                     device=device, use_lists=False, check_every=window,
                     cell_target=cell_target, telemetry=Telemetry(sinks=[sink]))
    nbr0 = sim.cfg.nbr
    if nbr0.window >= (1 << nbr0.level):
        raise AssertionError(f"h growth, Sedov {side}: the grid is in fold mode ({nbr0})")
    sim.state = dataclasses.replace(sim.state, h=sim.state.h * 4.0)
    diags = [sim.step() for _ in range(window)]
    grown = dataclasses.replace(state, h=state.h * (shrink * 4.0))
    ref = _run(Simulation(grown, box, const, device=device, use_lists=False,
                          cell_target=cell_target), window)
    if ([d.get("deferred") for d in diags[:-1]] != [1.0] * (window - 1)
            or diags[-1]["reconfigured"] != 1.0 or sim.rollbacks != 1
            or int(diags[-1]["occupancy"]) > sim.cfg.nbr.cap or sim.cfg.nbr != ref.cfg.nbr):
        raise AssertionError(f"h growth, Sedov {side}: rollbacks {sim.rollbacks}, last "
                             f"{diags[-1]}, nbr {sim.cfg.nbr} vs {ref.cfg.nbr}")
    err = _max_rel(f"h growth, Sedov {side}", sim.state, ref.state, {"x": 1e-6, "temp": 1e-5})
    return {"side": side, "window": window, "nbr_before": dataclasses.asdict(nbr0),
            "nbr_after": dataclasses.asdict(sim.cfg.nbr),
            "rollback": sink.of_kind("rollback")[0]["reason"], "max_rel_err": err}


def matches_sync(side: int, device, window: int = 4, steps: int = 6) -> dict:
    """Streaming Sedov ``side``, ``check_every=window`` against 1 over
    ``steps`` steps: every field and every science row equal bit for bit."""
    spec = ObservableSpec()
    runs = [_run(Simulation(*init_sedov(side, device=device), device=device, use_lists=False,
                            check_every=ce, obs_spec=spec, science_rows=True), steps)
            for ce in (1, window)]
    _max_rel(f"deferred vs checked, Sedov {side}", runs[1].state, runs[0].state,
             {f: 0 for f in FIELDS})
    rows = [r.drain_science() for r in runs]
    if rows[0] != rows[1] or len(rows[1]) != steps or runs[1].rollbacks:
        raise AssertionError(f"deferred vs checked, Sedov {side}: rows differ or rolled back")
    return {"side": side, "window": window, "steps": steps, "bitwise": True,
            "energy_drift": runs[1].energy_drift}


def list_expiry_replay(side: int, device, prop: str = "ve", window: int = 4,
                       case: str = "sedov") -> dict:
    """List mode (``prop``) on ``case`` ("sedov" or "noh") at ``side``: a
    first window builds the
    lists, then particle 0 moves by a whole skin; the next window runs on
    lists that no longer cover it, and its flush rolls back
    (``list-expiry``: a rebuild, no re-size) and replays the window (an
    earlier window may expire on its own, and roll back the same way). The
    result against a synchronous run with the same displacement (which
    discards and replays its one stale step), fields order-insensitive at
    the list-mode tolerances (x rtol 2e-6; v, temp 1e-4; tests/
    test_torch_list_slice.py)."""
    out = []
    for ce in (window, 1):
        sink = MemorySink()
        init = {"sedov": init_sedov, "noh": init_noh}[case]
        sim = Simulation(*init(side, device=device), prop=prop, device=device,
                         check_every=ce, obs_spec=ObservableSpec(),
                         telemetry=Telemetry(sinks=[sink]))
        _run(sim, window)
        if sim.lists is None:
            raise AssertionError(f"list expiry, {case} {side}: no lists")
        x = sim.state.x.clone()
        x[0] += sim.lists.skin
        sim.state = dataclasses.replace(sim.state, x=x)
        _run(sim, window)
        out.append((sim, sink))
    (sim, sink), (ref, _) = out
    rollbacks = [(e["it"], e["reason"]) for e in sink.of_kind("rollback")]
    if (not rollbacks or rollbacks[-1] != (2 * window, "list-expiry")
            or any(reason != "list-expiry" for _, reason in rollbacks)
            or len(sink.of_kind("replay")) != len(rollbacks) or sim.reconfigures
            or sim.iteration != 2 * window):
        raise AssertionError(f"list expiry, {case} {side}: rollbacks {rollbacks}, "
                             f"reconfigures {sim.reconfigures}")
    errs = {}
    for f, rtol in (("x", 2e-6), ("vx", 1e-4), ("temp", 1e-4)):
        a = torch.sort(getattr(sim.state, f).double().cpu()).values
        b = torch.sort(getattr(ref.state, f).double().cpu()).values
        scale = float(b.abs().max())
        errs[f] = float((a - b).abs().max()) / scale
        if not torch.allclose(a, b, rtol=rtol, atol=1e-7 * scale):
            raise AssertionError(f"list expiry, {case} {side}: {f} off the checked run "
                                 f"by {errs[f]} of scale")
    return {"prop": prop, "side": side, "window": window, "rollbacks": rollbacks,
            "replays": sim.replays, "rebuilds": [sim.rebuilds, ref.rebuilds],
            "max_err_over_scale": errs, "energy_drift": sim.energy_drift}


def sync_sites(fn, mode: str = "warn") -> collections.Counter:
    """Run ``fn()`` under torch's CUDA sync debug mode ``mode``: each
    synchronizing call (a device-to-host read, a stream or device
    synchronize) raises a warning ("warn", counted here by the repository
    line that made it) or an error ("error")."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    torch.cuda.set_sync_debug_mode(mode)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(f"{os.path.relpath(w.filename, root)}:{w.lineno}"
                               for w in caught if "synchroniz" in str(w.message))


def window_syncs(sim: Simulation) -> dict:
    """Host syncs of one whole deferred window on the card, by site, from
    an empty queue, with the window's list builds and rollbacks: a happy
    window without a build makes exactly one, its flush's read. Where the
    lists are in place (or the run streams) the launches before the flush
    run under the "error" mode, so that any sync there raises."""
    if sim._pending or sim.check_every < 2:
        raise AssertionError("window_syncs needs a deferred run and an empty window queue")
    b0, r0 = sim.rebuilds, sim.rollbacks

    def steps(n: int):
        return lambda: [sim.step() for _ in range(n)]

    sites = collections.Counter()
    if sim.lists is not None or not sim._use_lists:
        sync_sites(steps(sim.check_every - 1), "error")
        sites = sync_sites(steps(1))
    else:
        sites = sync_sites(steps(sim.check_every))
    return {"syncs": sum(sites.values()), "sites": dict(sites.most_common()),
            "rebuilds": sim.rebuilds - b0, "rollbacks": sim.rollbacks - r0}
