"""State carried across packages as numpy arrays and plain values.

``state_from_numpy`` builds the port's (ParticleState, Box, SimConstants)
from the fields of the JAX package's counterparts handed over as numpy
arrays and plain values; ``state_to_numpy`` goes back; ``tree_from_numpy``
builds the port's gravity tree from the JAX package's GravityTree arrays,
so that both packages can solve on one tree; ``turbulence_from_numpy``
and ``chemistry_from_numpy`` build the turb-ve and std-cooling steps' aux
state (TurbulenceState and TurbulenceConfig, ChemistryData) from the
JAX package's fields, ``blockdt_from_numpy`` / ``blockdt_to_numpy`` the
block time steps' BlockDtState, ``neighbor_config_from_dict`` the
neighbour search's config. None imports the JAX package: the caller
flattens its objects into dicts.
"""

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from sphexa_torch.gravity.tree import GravityTree, GravityTreeMeta
from sphexa_torch.neighbors.cell_list import NeighborConfig
from sphexa_torch.physics.cooling import CHEM_FIELDS, ChemistryData
from sphexa_torch.sfc.box import BoundaryType, Box
from sphexa_torch.sph.blockdt import BlockDtState
from sphexa_torch.sph.hydro_turb import TurbulenceConfig, TurbulenceState
from sphexa_torch.sph.particles import (
    PARTICLE_FIELDS, SCALAR_FIELDS, ParticleState, SimConstants,
)


def state_from_numpy(fields: Dict, box: Dict, const: Dict, device
                     ) -> Tuple[ParticleState, Box, SimConstants]:
    """``fields``: every ParticleState field name -> numpy array (1-D for
    per-particle fields, 0-d for ttot/min_dt/min_dt_m1); ``box``: lo, hi
    (3 values each) and boundaries (3 ints); ``const``: SimConstants field
    name -> value (unknown names are ignored)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32).copy(), device=device)

    state = ParticleState(**{f: f32(fields[f]) for f in PARTICLE_FIELDS + SCALAR_FIELDS})
    b = Box(lo=f32(box["lo"]), hi=f32(box["hi"]),
            boundaries=tuple(BoundaryType(int(v)) for v in box["boundaries"]))
    names = {f.name for f in dataclasses.fields(SimConstants)}
    c = SimConstants(**{k: v for k, v in const.items() if k in names}).normalized()
    return state, b, c


def state_to_numpy(state: ParticleState, box: Box, const: SimConstants
                   ) -> Tuple[Dict, Dict, Dict]:
    """Inverse of state_from_numpy."""
    fields = {f: getattr(state, f).detach().cpu().numpy()
              for f in PARTICLE_FIELDS + SCALAR_FIELDS}
    b = {"lo": box.lo.cpu().numpy(), "hi": box.hi.cpu().numpy(),
         "boundaries": [int(v) for v in box.boundaries]}
    return fields, b, dataclasses.asdict(const)


def tree_from_numpy(arrays: Dict, meta: Dict, device) -> Tuple[GravityTree, GravityTreeMeta]:
    """``arrays``: every GravityTree field name -> numpy array (the index
    fields of any integer type, widened to int64); ``meta``: num_leaves,
    num_nodes and level_ranges."""
    def to(name):
        a = np.asarray(arrays[name])
        if a.dtype.kind in "iu":
            a = a.astype(np.int64)
        return torch.as_tensor(a.copy(), device=device)

    tree = GravityTree(**{f.name: to(f.name) for f in dataclasses.fields(GravityTree)})
    m = GravityTreeMeta(num_leaves=int(meta["num_leaves"]), num_nodes=int(meta["num_nodes"]),
                        level_ranges=tuple((int(a), int(b)) for a, b in meta["level_ranges"]))
    return tree, m


def turbulence_from_numpy(state: Dict, cfg: Dict, device
                          ) -> Tuple[TurbulenceState, TurbulenceConfig]:
    """``state``: modes (M, 3), amplitudes (M,), phases (M, 3, 2) and the
    raw key (2,) as numpy arrays (the key as uint32); ``cfg``: every
    TurbulenceConfig field name -> value."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32).copy(), device=device)
    turb = TurbulenceState(modes=f32(state["modes"]), amplitudes=f32(state["amplitudes"]),
                           phases=f32(state["phases"]),
                           key=np.asarray(state["key"], np.uint32).copy())
    return turb, TurbulenceConfig(**cfg)


def chemistry_from_numpy(fields: Dict, device) -> ChemistryData:
    """``fields``: every ChemistryData field name -> (n,) numpy array."""
    return ChemistryData(**{k: torch.as_tensor(np.asarray(fields[k], np.float32).copy(),
                                               device=device) for k in CHEM_FIELDS})


def neighbor_config_from_dict(cfg: Dict) -> NeighborConfig:
    """The port's NeighborConfig from the JAX package's (its fields as a
    dict, ``dataclasses.asdict``): level, cap, ngmax, block, curve, group
    and window as they are, so that a search runs on the JAX config's
    exact grid; its engine-only fields (chunk_pair) dropped, and a
    run_cap of 0 (merging off, which the port's engine never runs) with
    its gap replaced by the port's defaults."""
    names = {f.name for f in dataclasses.fields(NeighborConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    if kw.get("run_cap", 1) <= 0:
        kw.pop("run_cap")
        kw.pop("gap", None)
    return NeighborConfig(**kw)


#: BlockDtState field -> its numpy dtype (the JAX package's)
_BLOCKDT_DTYPES = {"bins": np.int32, "dt_prev": np.float32, "substep": np.int32,
                   "cycle": np.int32, "dt_min": np.float32}


def blockdt_from_numpy(fields: Dict, device) -> BlockDtState:
    """``fields``: every BlockDtState field name -> numpy array (bins and
    dt_prev (n,), the rest 0-d)."""
    return BlockDtState(**{k: torch.as_tensor(np.asarray(fields[k], dt).copy(), device=device)
                           for k, dt in _BLOCKDT_DTYPES.items()})


def blockdt_to_numpy(bst: BlockDtState) -> Dict:
    """Inverse of blockdt_from_numpy."""
    return {k: getattr(bst, k).detach().cpu().numpy() for k in _BLOCKDT_DTYPES}
