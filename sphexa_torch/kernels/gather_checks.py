"""Card checks of the gather backend, shared by chip_smoke.py's
``gather_path`` phase and tests/test_torch_gpu.py (``-k gather``):

- ``card_vs_cpu``: ``find_neighbors`` of a jittered, truncating Sedov
  state on the card against the CPU, nidx, nmask, nc and occupancy bit
  for bit, and the gather density within rtol 1e-6 (float32 sums of a
  row in another order);
- ``vs_engine``: the gather backend's std force stage against the
  engine's (streaming K1) from one state in which no row has ngmax
  neighbours, where both sum the same pairs: rho rtol 1e-5, a and du
  rtol 1e-4 / atol 5e-6 max|.| (tests/test_torch_ops.py's tolerances);
- ``split_ms``: the stages of a gather step on the current state, each
  timed alone (sort, search, density, EOS, IAD, momentum/energy);
- ``block_sizes``: the row blocks the search and each op take on the
  device (``util/blocking.device_block``).

No kernel runs on the gather backend; ``vs_engine`` launches K1 for its
reference.
"""

import time
from typing import Dict

import torch

from sphexa_torch.convert import state_from_numpy, state_to_numpy
from sphexa_torch.init import init_sedov, jitter_sedov
from sphexa_torch.neighbors.cell_list import _PAIR_BYTES, find_neighbors
from sphexa_torch.propagator import _sort_by_keys, _std_forces
from sphexa_torch.simulation import make_propagator_config
from sphexa_torch.sph import hydro_std
from sphexa_torch.util.blocking import device_block

#: the gather density on the card against the CPU (the same pairs, summed
#: in another order)
DENSITY_RTOL = 1e-6


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sorted_case(side: int, ngmax: int, device, seed: int = 7):
    """A jittered Sedov state (numpy-seeded), sorted on ``device``, its
    gather config at ``ngmax`` and keys."""
    state, box, const = init_sedov(side, device="cpu")
    fields, b, c = state_to_numpy(state, box, const)
    state, box, const = state_from_numpy(jitter_sedov(fields, side, seed), b, c, device=device)
    cfg = make_propagator_config(state, box, const, ngmax=ngmax, backend="xla")
    ss, keys, _ = _sort_by_keys(state, box, cfg.curve)
    return ss, box, const, cfg, keys


def card_vs_cpu(side: int = 30, ngmax: int = 40) -> Dict:
    """The search and the density on the card against the CPU."""
    out = {}
    for dev in ("cpu", "cuda"):
        ss, box, const, cfg, keys = _sorted_case(side, ngmax, dev)
        lists = find_neighbors(ss.x, ss.y, ss.z, ss.h, keys, box, cfg.nbr)
        rho = hydro_std.compute_density(ss.x, ss.y, ss.z, ss.h, ss.m, *lists[:2], box, const,
                                        cfg.nbr.block)
        out[dev] = [a.cpu() for a in lists] + [rho.cpu()]
    for name, a, b in zip(("nidx", "nmask", "nc", "occupancy"), out["cuda"], out["cpu"]):
        if not torch.equal(a, b):
            raise AssertionError(f"find_neighbors side {side} ngmax {ngmax}: {name} differs "
                                 f"card vs cpu ({int((a != b).sum())} entries)")
    rho_g, rho_c = out["cuda"][4], out["cpu"][4]
    torch.testing.assert_close(rho_g, rho_c, rtol=DENSITY_RTOL, atol=0.0,
                               msg=f"gather density side {side}: card vs cpu")
    nc = out["cpu"][2]
    return {"side": side, "n": int(nc.shape[0]), "ngmax": ngmax, "bits_equal": True,
            "truncated_rows": int((nc > ngmax).sum()), "nc_max": int(nc.max()),
            "density_max_rel_err": float(((rho_g - rho_c).abs() / rho_c.abs()).max())}


def vs_engine(state, box, const) -> Dict:
    """One force stage of each backend on ``state`` (sorted by either
    prologue the same way)."""
    res = {}
    for backend in ("xla", "pallas"):
        cfg = make_propagator_config(state, box, const, backend=backend)
        out = _std_forces(state, box, cfg)
        res[backend] = {"rho": out[10], "ax": out[2], "ay": out[3], "az": out[4], "du": out[5],
                        "nc": out[8], "dt": out[6]}
    g, e = res["xla"], res["pallas"]
    nc_max = int(g["nc"].max())
    if nc_max >= cfg.nbr.ngmax:
        raise AssertionError(f"vs_engine: a row has {nc_max} >= ngmax neighbours")
    torch.testing.assert_close(g["rho"], e["rho"], rtol=1e-5, atol=0.0, msg="rho")
    errs = {"rho": float(((g["rho"] - e["rho"]).abs() / e["rho"].abs()).max())}
    for k in ("ax", "ay", "az", "du"):
        scale = float(e[k].abs().max())
        torch.testing.assert_close(g[k], e[k], rtol=1e-4, atol=5e-6 * scale, msg=k)
        errs[k] = float((g[k] - e[k]).abs().max()) / (scale or 1.0)
    return {"n": int(state.n), "nc_max": nc_max, "ngmax": cfg.nbr.ngmax,
            "nc_sum": [int(g["nc"].sum()), int(e["nc"].sum())],
            "dt_courant": [float(g["dt"]), float(e["dt"])], "max_err_over_scale": errs}


def _t(fn, dev, reps: int):
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(dev)
    return out, 1e3 * (time.perf_counter() - t0) / reps


def split_ms(sim, reps: int = 1) -> Dict[str, float]:
    """The stages of a std gather step on ``sim``'s current state (after
    its steps: nothing left to warm up), each run ``reps`` times back to
    back with the card synchronized around them: ms per stage (the
    split's sum bounds the step above)."""
    cfg, dev = sim.cfg, sim.device
    const, nbr, box = cfg.const, cfg.nbr, sim.box
    out = {}
    (ss, keys, _), out["sort"] = _t(lambda: _sort_by_keys(sim.state, box, cfg.curve), dev, reps)
    x, y, z, h, m = ss.x, ss.y, ss.z, ss.h, ss.m
    (nidx, nmask, _, _), out["search"] = _t(
        lambda: find_neighbors(x, y, z, h, keys, box, nbr), dev, reps)
    lst = (nidx, nmask)
    rho, out["density"] = _t(lambda: hydro_std.compute_density(x, y, z, h, m, *lst, box, const,
                                                               nbr.block), dev, reps)
    (p, c), out["eos"] = _t(lambda: hydro_std.compute_eos_std(ss.temp, rho, const), dev, reps)
    cs, out["iad"] = _t(lambda: hydro_std.compute_iad(x, y, z, h, m / rho, *lst, box, const,
                                                      nbr.block), dev, reps)
    _, out["momentum_energy"] = _t(lambda: hydro_std.compute_momentum_energy_std(
        x, y, z, ss.vx, ss.vy, ss.vz, h, m, rho, p, c, *cs, *lst, box, const, nbr.block), dev,
        reps)
    return out


def block_sizes(cfg, device) -> Dict[str, int]:
    """Rows a block takes on ``device`` at ``cfg``'s search: the search's
    groups a chunk (its candidates W^3 cap) and each op's rows a block."""
    nbr = cfg.nbr
    ncand = nbr.window**3 * nbr.cap
    fields = dict(hydro_std.TILE_FIELDS)
    return {"search_groups": device_block(nbr.block, ncand * _PAIR_BYTES, device) // nbr.group,
            "search_candidates": ncand,
            **{f"{op}_rows": device_block(nbr.block, nbr.ngmax * 4 * k, device)
               for op, k in fields.items()}}

