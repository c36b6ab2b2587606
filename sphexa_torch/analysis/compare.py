"""Output fields and the L1 comparison against an analytic solution
(sphexa_tpu/analysis/compare.py).

``compute_output_fields`` is the saveFields recompute pass
(ve_hydro.hpp:225-286): rho, p and c derived from the conserved fields
through the pair engine in streaming mode, K1 on the card (std: the
density op; VE: xmass, then grad-h), or on the gather backend
(``cfg.backend`` "xla") through find_neighbors' lists and the gather
ops, as the JAX package's XLA branch; and u, |v| and r; on a mesh
(``cfg.mesh``) over this rank's slab, K1's jdata form on the sharded
halo (on the gather backend the gather ops on the gather halo), each
row's fields returned to the rank that holds it.
``l1_error`` is
the reference's metric, sum |sol - sim| / N at every particle's radius
(compare_solutions.py, compare_noh.py)."""

import dataclasses
from typing import Dict

import numpy as np
import torch

from sphexa_torch.neighbors.cell_list import find_neighbors
from sphexa_torch.propagator import PropagatorConfig, _sort_by_keys
from sphexa_torch.sfc.box import Box
from sphexa_torch.sph import hydro_std, hydro_ve
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.hydro_std import compute_eos_std
from sphexa_torch.sph.hydro_ve import compute_eos_ve
from sphexa_torch.sph.particles import ParticleState

#: the pair ops of the pass: the kernel wrappers (K1 on the card, the plain
#: versions on the CPU) or the plain versions on any device
OPS = {"kernel": (pe.pallas_density, pe.pallas_xmass, pe.pallas_ve_def_gradh),
       "plain": (pe.density_plain, pe.xmass_plain, pe.ve_def_gradh_plain)}


def output_fields(state: ParticleState, box: Box, cfg: PropagatorConfig,
                  pipeline: str = "std", ops: str = "kernel") -> Dict[str, torch.Tensor]:
    """The output fields as tensors on the state's device, in the state's
    particle order (the pair ops run in key order; their results are
    scattered back, so they line up with the conserved fields a snapshot
    writes). ``cfg``: the run's config; its neighbour config is used as
    it is unless the state has outgrown it (a cell past the cap or a
    group past the window), when a config is sized for this state as the
    Simulation sizes one. ``pipeline``: the density estimator of the
    propagator that evolved the state, "std" or "ve". On a mesh the
    state is this rank's slab (``_output_fields_sharded``)."""
    if cfg.mesh is not None:
        return _output_fields_sharded(state, box, cfg, pipeline, ops)
    const = cfg.const
    ss, keys, order = _sort_by_keys(state, box, cfg.curve)
    x, y, z, h, m = ss.x, ss.y, ss.z, ss.h, ss.m
    nbr = cfg.nbr
    if cfg.backend == "xla":
        rho, p, c = _gather_fields(ss, keys, box, cfg, pipeline, state)
        return _finish(state, const, order, rho, p, c)
    density, xmass, ve_def_gradh = OPS[ops]
    ranges = pe.group_cell_ranges(x, y, z, h, keys, box, nbr)
    if int(ranges.occupancy) > nbr.cap:
        from sphexa_torch.simulation import make_propagator_config

        nbr = make_propagator_config(state, box, const, curve=cfg.curve).nbr
        ranges = pe.group_cell_ranges(x, y, z, h, keys, box, nbr)
    if pipeline == "ve":
        xm, _, _ = xmass(x, y, z, h, m, keys, box, const, nbr, ranges=ranges)
        (kx, gradh), _ = ve_def_gradh(x, y, z, h, m, xm, keys, box, const, nbr, ranges=ranges)
        _, c, rho, p = compute_eos_ve(ss.temp, m, kx, xm, gradh, const)
    else:
        rho, _, _ = density(x, y, z, h, m, keys, box, const, nbr, ranges=ranges)
        p, c = compute_eos_std(ss.temp, rho, const)
    return _finish(state, const, order, rho, p, c)


def _gather_fields(ss: ParticleState, keys, box: Box, cfg: PropagatorConfig, pipeline: str,
                   state: ParticleState):
    """rho, p and c of the sorted state ``ss`` on the gather backend (the
    JAX package's XLA branch): find_neighbors' lists, then the density (VE:
    xmass, then grad-h) and the EOS. The run's neighbour config unless
    the state has outgrown it, when one is sized for ``state``."""
    const, nbr = cfg.const, cfg.nbr
    x, y, z, h, m = ss.x, ss.y, ss.z, ss.h, ss.m
    nidx, nmask, _, occ = find_neighbors(x, y, z, h, keys, box, nbr)
    if int(occ) > nbr.cap:
        from sphexa_torch.simulation import make_propagator_config

        nbr = make_propagator_config(state, box, const, ngmax=nbr.ngmax, block=nbr.block,
                                     curve=cfg.curve, backend="xla").nbr
        nidx, nmask, _, _ = find_neighbors(x, y, z, h, keys, box, nbr)
    if pipeline == "ve":
        xm = hydro_ve.compute_xmass(x, y, z, h, m, nidx, nmask, box, const, nbr.block)
        kx, gradh = hydro_ve.compute_ve_def_gradh(x, y, z, h, m, xm, nidx, nmask, box, const,
                                                  nbr.block)
        _, c, rho, p = compute_eos_ve(ss.temp, m, kx, xm, gradh, const)
        return rho, p, c
    rho = hydro_std.compute_density(x, y, z, h, m, nidx, nmask, box, const, nbr.block)
    p, c = compute_eos_std(ss.temp, rho, const)
    return rho, p, c


def _finish(state: ParticleState, const, order, rho, p, c) -> Dict[str, torch.Tensor]:
    """The output fields in the state's particle order: the sorted rho, p
    and c scattered back, u, |v| and r from the state."""
    def unsort(a):
        out = torch.empty_like(a)
        out[order] = a
        return out

    return {"r": torch.sqrt(state.x**2 + state.y**2 + state.z**2), "rho": unsort(rho),
            "p": unsort(p), "u": const.cv * state.temp,
            "vel": torch.sqrt(state.vx**2 + state.vy**2 + state.vz**2), "c": unsort(c)}


def _output_fields_sharded(state: ParticleState, box: Box, cfg: PropagatorConfig,
                           pipeline: str, ops: str) -> Dict[str, torch.Tensor]:
    """``output_fields`` on this rank's slab, with no gather: the slabs
    sorted across ranks with each row's global index riding the sort
    (parallel/sort.py), the density (VE: xmass, then grad-h) over the
    sparse halo sized for this state (K1's jdata form), the EOS, then
    rho, p and c sent back to the ranks and rows that hold them (a second
    all_to_all on the transposed cut table). The neighbour config is the
    run's unless the state has outgrown it (the densest cell past the cap
    on any rank), when one is sized for this state. Host reads: the sort's
    cut tables, the halo caps, the occupancy. On the gather backend the
    density is ``_gather_fields_sharded``'s."""
    from sphexa_torch.parallel import exchange as ex
    from sphexa_torch.parallel.mesh import reduce_scalars
    from sphexa_torch.parallel.sizing import device_sparse_halo
    from sphexa_torch.parallel.sort import sort_slabs
    from sphexa_torch.sfc.keys import compute_sfc_keys

    density, xmass, ve_def_gradh = OPS[ops]
    mesh, const, S = cfg.mesh, cfg.const, state.n
    keys = compute_sfc_keys(state.x, state.y, state.z, box, curve=cfg.curve)
    gidx = mesh.rank * S + torch.arange(S, dtype=torch.int64, device=keys.device)
    cols = torch.stack([state.x, state.y, state.z, state.h, state.m, state.temp], dim=1)
    srt = sort_slabs(mesh, keys, cols, extra=[gidx])
    x, y, z, h, m, temp = (a.contiguous() for a in srt.rows.unbind(1))
    skeys = srt.keys
    nbr = cfg.nbr
    if cfg.backend == "xla":
        rho, p, c = _gather_fields_sharded(cfg, x, y, z, h, m, temp, skeys, box, pipeline,
                                           state)
        return _owners(mesh, state, const, srt, rho, p, c)
    for attempt in range(2):
        snbr = ex.slab_nbr(nbr, S)
        hmax = device_sparse_halo(mesh, x, y, z, h, skeys, box, nbr, margin=1.0)
        ranges, serve, jbuf, escaped, _ = ex.shard_halo_stage_sparse(
            mesh, x, y, z, h, skeys, box, snbr, hmax)
        hx, hy, hz, hm = serve((x, y, z, m))
        jd = jbuf((x, y, z, m), (hx, hy, hz, hm))
        if pipeline == "ve":
            xm, _, occ = xmass(x, y, z, h, m, None, box, const, snbr, ranges=ranges, jdata=jd)
        else:
            rho, _, occ = density(x, y, z, h, m, None, box, const, snbr, ranges=ranges,
                                  jdata=jd)
        _, (occ, esc), _ = reduce_scalars(mesh, maxes=[occ, escaped.to(torch.int32)])
        if int(esc):
            raise RuntimeError("output fields: runs escaped a halo sized for this state")
        if int(occ) <= nbr.cap or attempt:
            break
        from sphexa_torch.simulation import make_propagator_config

        nbr = make_propagator_config(state, box, const, curve=cfg.curve, mesh=mesh).nbr
    if pipeline == "ve":
        (hxm,) = serve((xm,))
        (kx, gradh), _ = ve_def_gradh(x, y, z, h, m, xm, None, box, const, snbr, ranges=ranges,
                                      jdata=jbuf((x, y, z, m, xm), (hx, hy, hz, hm, hxm)))
        _, c, rho, p = compute_eos_ve(temp, m, kx, xm, gradh, const)
    else:
        p, c = compute_eos_std(temp, rho, const)
    return _owners(mesh, state, const, srt, rho, p, c)


def _owners(mesh, state: ParticleState, const, srt, rho, p, c) -> Dict[str, torch.Tensor]:
    """The output fields of this rank's rows: the sorted rows' rho, p and c
    sent back to the ranks and rows that hold them, u, |v| and r from the
    state."""
    from sphexa_torch.parallel.sort import to_owners

    rho, p, c = to_owners(mesh, torch.stack([rho, p, c], dim=1), srt.extra[0], srt).unbind(1)
    return {"r": torch.sqrt(state.x**2 + state.y**2 + state.z**2), "rho": rho.contiguous(),
            "p": p.contiguous(), "u": const.cv * state.temp,
            "vel": torch.sqrt(state.vx**2 + state.vy**2 + state.vz**2), "c": c.contiguous()}


def _gather_fields_sharded(cfg: PropagatorConfig, x, y, z, h, m, temp, skeys, box: Box,
                           pipeline: str, state: ParticleState):
    """``_gather_fields`` on this rank's sorted slab: the gather halo
    sized for this state, the search of the global groups that meet the
    slab (``propagator._gather_stage``), the density (VE: xmass, then
    grad-h, a second serve) on the [own | halo] j-buffers and the EOS. The
    run's neighbour config unless the state has outgrown it on any rank
    (the global occupancy past the cap), when one is sized for this
    state."""
    from sphexa_torch.parallel.exchange import jbuf
    from sphexa_torch.parallel.mesh import reduce_scalars
    from sphexa_torch.parallel.sizing import device_gather_halo
    from sphexa_torch.propagator import _gather_stage

    mesh, const, nbr = cfg.mesh, cfg.const, cfg.nbr
    for attempt in range(2):
        hmax = device_gather_halo(mesh, x, y, z, h, skeys, box, nbr, margin=1.0)
        scfg = dataclasses.replace(cfg, nbr=nbr, halo_cells=hmax)
        st, first, nidx, nmask, _, escaped, _ = _gather_stage(scfg, x, y, z, h, skeys, box,
                                                              (x, y, z, m))
        _, (occ, esc), (ok,) = reduce_scalars(mesh, maxes=[st.win.occ, escaped.to(torch.int32)],
                                              mins=[st.win.window_ok.to(torch.int32)])
        if int(esc):
            raise RuntimeError("output fields: rows escaped a halo sized for this state")
        if (int(occ) <= nbr.cap and int(ok)) or attempt:
            break
        from sphexa_torch.simulation import make_propagator_config

        nbr = make_propagator_config(state, box, const, ngmax=nbr.ngmax, block=nbr.block,
                                     curve=cfg.curve, mesh=mesh, backend="xla").nbr
    jx, jy, jz, jm = jbuf((x, y, z, m), first)
    lst = (nidx, nmask)
    if pipeline == "ve":
        xm = hydro_ve.compute_xmass(jx, jy, jz, h, jm, *lst, box, const, nbr.block)
        (jxm,) = jbuf((xm,), st.serve((xm,)))
        kx, gradh = hydro_ve.compute_ve_def_gradh(jx, jy, jz, h, jm, jxm, *lst, box, const,
                                                  nbr.block)
        _, c, rho, p = compute_eos_ve(temp, m, kx, xm, gradh, const)
        return rho, p, c
    rho = hydro_std.compute_density(jx, jy, jz, h, jm, *lst, box, const, nbr.block)
    p, c = compute_eos_std(temp, rho, const)
    return rho, p, c


def compute_output_fields(state: ParticleState, box: Box, cfg: PropagatorConfig,
                          pipeline: str = "std") -> Dict[str, np.ndarray]:
    """The dependent output fields (rho, p, u, |v|, c) and the radii of a
    conserved-field state, as numpy arrays in the state's particle order
    (``output_fields``; on a mesh this rank's rows)."""
    out = output_fields(state, box, cfg, "ve" if pipeline == "ve" else "std")
    return {k: v.cpu().numpy() for k, v in out.items()}


def l1_error(sim: np.ndarray, sol: np.ndarray) -> float:
    """Reference L1 metric: mean absolute deviation (compare_noh.py:146)."""
    sim = np.asarray(sim, np.float64)
    sol = np.asarray(sol, np.float64)
    return float(np.abs(sol - sim).sum() / sim.shape[0])
