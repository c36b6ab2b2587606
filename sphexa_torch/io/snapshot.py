"""Snapshot writer/reader (sphexa_tpu/io/snapshot.py): HDF5 with one
``Step#n`` group per dump (H5Part style), or a one-snapshot ``.npz``.

The layout, attribute names and dtypes are the JAX package's, so a dump
written by either package restarts in the other:

    dump.h5
    └── Step#0
        ├── attrs: iteration, numParticlesGlobal, time, minDt, minDt_m1,
        │          box_lo, box_hi, box_boundaries, the SimConstants under
        │          the reference's names, [initCase, caseSettings]
        ├── x, y, z, x_m1, ..., alpha   (one dataset per conserved field)
        └── rho, p, ...                 (optional derived output fields)

A dump written on a mesh is a set of part files
``<base>.partKKKofPPP<ext>`` (``write_snapshot_sharded``, the JAX
package's layout: each part a rank's rows, the global tables in part 0);
reading the base path reassembles them, whichever package wrote them.
"""

import glob
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.device import resolve_device
from sphexa_torch.sfc.box import Box
from sphexa_torch.sph.particles import ParticleState, SimConstants

try:
    import h5py

    _HAVE_H5PY = True
except ImportError:  # the card machine has no h5py: .npz only there
    _HAVE_H5PY = False

# conserved per-particle fields: the restartable set
CONSERVED_FIELDS = (
    "x", "y", "z", "x_m1", "y_m1", "z_m1", "vx", "vy", "vz",
    "h", "m", "temp", "du", "du_m1", "alpha",
)

# SimConstants fields serialized as attributes, reference attribute names
# (particles_data.hpp:170-191); ``sym_pairs`` keeps a restart on the
# writing run's pair-cutoff convention
_CONST_ATTRS = {
    "ng0": "ng0", "ngmax": "ngmax", "k_cour": "Kcour", "k_rho": "Krho",
    "gamma": "gamma", "mui": "muiConst", "alphamin": "alphamin",
    "alphamax": "alphamax", "decay_constant": "decay_constant",
    "at_min": "Atmin", "at_max": "Atmax", "g": "gravConstant",
    "eps": "eps", "eta_acc": "etaAcc", "max_dt_increase": "maxDtIncrease",
    "sinc_index": "sincIndex", "kernel_choice": "kernelChoice",
    "sym_pairs": "symPairs",
}


def _is_h5(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in (".h5", ".hdf5", ".h5part")


def _np(v) -> np.ndarray:
    """A host numpy array of a tensor (any device) or array-like."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _step_attrs(state: ParticleState, box: Box, const: SimConstants,
                iteration: int, num_particles_global: Optional[int] = None
                ) -> Dict[str, np.ndarray]:
    attrs = {
        "iteration": np.int64(iteration),
        "numParticlesGlobal": np.int64(state.n if num_particles_global is None
                                       else num_particles_global),
        "time": np.float64(float(state.ttot)),
        "minDt": np.float64(float(state.min_dt)),
        "minDt_m1": np.float64(float(state.min_dt_m1)),
        "box_lo": np.asarray(_np(box.lo), np.float64),
        "box_hi": np.asarray(_np(box.hi), np.float64),
        "box_boundaries": np.asarray([int(b) for b in box.boundaries], np.int64),
    }
    for field, name in _CONST_ATTRS.items():
        v = getattr(const, field)
        attrs[name] = np.bytes_(v.encode()) if isinstance(v, str) else np.float64(v)
    return attrs


def write_snapshot(path: str, state: ParticleState, box: Box, const: SimConstants,
                   iteration: int = 0, extra_fields: Optional[Dict] = None,
                   case: str = "", case_settings: Optional[Dict] = None,
                   num_particles_global: Optional[int] = None) -> int:
    """Append one restartable snapshot (a ``.h5`` path gains a Step#n
    group; any other path is written as one ``.npz``); returns the step
    index written. ``extra_fields``: derived output datasets (rho, p, ...;
    tensors or arrays); ``case`` and ``case_settings`` are recorded so
    that a restart re-selects the case's observable with its overrides.
    ``num_particles_global``: the whole run's count, where ``state`` is a
    part of it (``write_snapshot_sharded``)."""
    fields = {f: _np(getattr(state, f)) for f in CONSERVED_FIELDS}
    if extra_fields:
        fields.update({k: _np(v) for k, v in extra_fields.items()})
    attrs = _step_attrs(state, box, const, iteration, num_particles_global)
    if case:
        attrs["initCase"] = np.bytes_(case)
    if case_settings:
        attrs["caseSettings"] = np.bytes_(json.dumps(case_settings))

    if _is_h5(path):
        if not _HAVE_H5PY:
            raise RuntimeError("h5py unavailable; use a .npz path instead")
        with h5py.File(path, "a") as f:
            step = len([k for k in f.keys() if k.startswith("Step#")])
            g = f.create_group(f"Step#{step}")
            for k, v in attrs.items():
                g.attrs[k] = v
            for k, v in fields.items():
                g.create_dataset(k, data=v)
            return step

    arrays = {f"field_{k}": v for k, v in fields.items()}
    arrays.update({f"attr_{k}": v for k, v in attrs.items()})
    np.savez_compressed(path, **arrays)
    return 0


def _part_path(path: str, k: int, P: int) -> str:
    base, ext = os.path.splitext(path)
    return f"{base}.part{k:03d}of{P:03d}{ext}"


def write_snapshot_sharded(path: str, state: ParticleState, box: Box, const: SimConstants,
                           iteration: int = 0, extra_fields: Optional[Dict] = None,
                           case: str = "", case_settings: Optional[Dict] = None,
                           mesh=None, global_fields: Optional[Dict] = None) -> int:
    """One part file a rank, with no gather: rank k of P writes its slab
    ``state`` to ``<base>.part<k>of<P><ext>`` (the JAX package's sharded
    dumps, file for file: an ordinary snapshot of the slab's rows, the
    global count in its attributes; per-particle ``extra_fields`` are the
    slab's, such as the derived output fields, and other arrays among them
    go to part 0 only; ``global_fields``, tables such as the stirring
    state, go to part 0 whatever their shape). ``read_snapshot`` of the
    base path reassembles the parts. Without a mesh (or one rank) it is
    ``write_snapshot``. Returns the step index written."""
    if mesh is None or mesh.size <= 1:
        return write_snapshot(path, state, box, const, iteration,
                              {**(extra_fields or {}), **(global_fields or {})} or None, case,
                              case_settings)
    k, P, rows = mesh.rank, mesh.size, state.n
    ex = {name: v for name, v in (extra_fields or {}).items()
          if k == 0 or (v.ndim >= 1 and v.shape[0] == rows)}
    if k == 0:
        ex.update(global_fields or {})
    return write_snapshot(_part_path(path, k, P), state, box, const, iteration, ex or None,
                          case, case_settings, num_particles_global=rows * P)


def _find_parts(path: str) -> List[str]:
    """Existing part files of a sharded snapshot's base path (sorted)."""
    base, ext = os.path.splitext(path)
    return sorted(glob.glob(f"{base}.part*of*{ext}"))


def _h5_steps(f) -> List[int]:
    return sorted(int(k.split("#")[1]) for k in f.keys() if k.startswith("Step#"))


def list_steps(path: str) -> List[int]:
    """Step indices present in a snapshot file; on a sharded base path the
    steps present in every part (a torn dump's extra step is not
    readable, so it is not listed)."""
    if not os.path.exists(path):
        parts = _find_parts(path)
        if parts:
            common: Optional[set] = None
            for p in parts:
                s = set(list_steps(p))
                common = s if common is None else (common & s)
            return sorted(common or ())
    if _is_h5(path):
        with h5py.File(path, "r") as f:
            return _h5_steps(f)
    return [0]


def _resolve_step(steps: List[int], step: int, path: str) -> int:
    """Validate a step selector against the file's Step#n indices;
    negative counts from the end."""
    if not steps:
        raise ValueError(f"{path} contains no Step#n groups")
    if step < 0:
        if -step > len(steps):
            raise ValueError(f"step {step} out of range for {path}; have {steps}")
        return steps[step]
    if step not in steps:
        raise ValueError(f"step {step} not in {path}; have {steps}")
    return step


def _read_raw(path: str, step: int):
    if not os.path.exists(path):
        parts = _find_parts(path)
        if parts:
            return _read_parts(path, parts, step)
    return _read_raw_one(path, step)


def _read_parts(path: str, parts: List[str], step: int):
    """A sharded snapshot: the parts' rows concatenated in part order,
    attributes from part 0. Refuses an incomplete part set and a torn
    dump (parts resolving to different iterations)."""
    m = re.search(r"part\d+of(\d+)", parts[0])
    declared = int(m.group(1)) if m else len(parts)
    if len(parts) != declared:
        raise ValueError(
            f"{path}: sharded snapshot has {len(parts)} part files but names "
            f"declare {declared} shards (incomplete dump or mixed part sets)")
    step = _resolve_step(list_steps(path), step, path)
    fields_all, attrs = None, None
    for p in parts:
        f, a = _read_raw_one(p, step)
        if fields_all is None:
            fields_all, attrs = {k: [v] for k, v in f.items()}, a
            continue
        if (int(a["iteration"]) != int(attrs["iteration"])
                or float(a["time"]) != float(attrs["time"])):
            raise ValueError(
                f"{p}: part resolves to iteration {int(a['iteration'])} != part 0's "
                f"{int(attrs['iteration'])}: torn sharded dump; pass an explicit "
                "step index for the last complete dump")
        for k, v in f.items():
            fields_all.setdefault(k, []).append(v)
    # per-particle fields are in every part; part-0-only fields are global tables
    out = {k: (np.concatenate(v) if len(v) == len(parts) else v[0])
           for k, v in fields_all.items()}
    return out, attrs


def _read_raw_one(path: str, step: int):
    if _is_h5(path):
        if not _HAVE_H5PY:
            raise RuntimeError("h5py unavailable; use a .npz path instead")
        with h5py.File(path, "r") as f:
            idx = _resolve_step(_h5_steps(f), step, path)
            g = f[f"Step#{idx}"]
            fields = {k: np.asarray(g[k]) for k in g.keys()}
            attrs = {k: np.asarray(v) for k, v in g.attrs.items()}
            return fields, attrs
    _resolve_step([0], step, path)  # an npz holds exactly one snapshot
    with np.load(path) as data:
        fields = {k[6:]: data[k] for k in data.files if k.startswith("field_")}
        attrs = {k[5:]: data[k] for k in data.files if k.startswith("attr_")}
    return fields, attrs


def read_step_attrs(path: str, step: int = -1) -> Dict[str, np.ndarray]:
    """The step's attributes only (iteration, time, constants): restart
    metadata without the particle datasets."""
    if not os.path.exists(path):
        parts = _find_parts(path)
        if parts:
            step, path = _resolve_step(list_steps(path), step, path), parts[0]
    if _is_h5(path):
        with h5py.File(path, "r") as f:
            idx = _resolve_step(_h5_steps(f), step, path)
            return {k: np.asarray(v) for k, v in f[f"Step#{idx}"].attrs.items()}
    _, attrs = _read_raw(path, step)
    return attrs


def read_snapshot(path: str, step: int = -1, device=None
                  ) -> Tuple[ParticleState, Box, SimConstants, Dict[str, np.ndarray]]:
    """Restore (state, box, const, extra_fields) from a snapshot onto
    ``device`` (the card unless ``"cpu"``). ``step``: index into the
    file's Step#n groups; negative counts from the end."""
    state, box, const, extra, _ = read_snapshot_full(path, step, device)
    return state, box, const, extra


def _constants(attrs: Dict[str, np.ndarray]) -> Dict:
    const_kw = {}
    for field, name in _CONST_ATTRS.items():
        if name not in attrs:
            continue
        if field == "kernel_choice":
            v = attrs[name]
            v = v.item() if hasattr(v, "item") else v
            const_kw[field] = v.decode() if isinstance(v, bytes) else str(v)
        elif field == "sym_pairs":
            const_kw[field] = bool(int(float(attrs[name])))
        else:
            const_kw[field] = (int if field in ("ng0", "ngmax") else float)(attrs[name])
    return const_kw


def read_snapshot_full(path: str, step: int = -1, device=None
                       ) -> Tuple[ParticleState, Box, SimConstants, Dict[str, np.ndarray],
                                  Dict[str, np.ndarray]]:
    """``read_snapshot`` and the raw step attributes (iteration, initCase,
    ...) in one read. The fields become float32 tensors on ``device``;
    ``temp_lo``, the energy update's two-sum carry, is not serialized (it
    is below one ulp of temp) and restarts at zero."""
    dev = resolve_device(device)
    fields, attrs = _read_raw(path, step)
    missing = [f for f in CONSERVED_FIELDS if f not in fields]
    if missing:
        raise ValueError(f"{path} is not restartable: missing fields {missing}")
    per_particle = {f: fields[f] for f in CONSERVED_FIELDS}
    per_particle["temp_lo"] = np.zeros_like(fields["temp"], np.float32)
    scalars = {"ttot": np.float32(attrs["time"]), "min_dt": np.float32(attrs["minDt"]),
               "min_dt_m1": np.float32(attrs["minDt_m1"])}
    box = {"lo": attrs["box_lo"], "hi": attrs["box_hi"], "boundaries": attrs["box_boundaries"]}
    state, box, const = state_from_numpy({**per_particle, **scalars}, box,
                                         _constants(attrs), dev)
    extra = {k: v for k, v in fields.items() if k not in CONSERVED_FIELDS}
    return state, box, const, extra, attrs


def write_ascii(path: str, columns: Dict, delimiter: str = " ") -> None:
    """Plain-text column dump (the --ascii output, not restartable): one
    header line, one row per particle."""
    names = list(columns)
    data = np.column_stack([_np(columns[k]) for k in names])
    np.savetxt(path, data, delimiter=delimiter, header=delimiter.join(names))
