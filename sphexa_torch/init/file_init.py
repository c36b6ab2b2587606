"""Restart from a snapshot file (sphexa_tpu/init/file_init.py; the
reference's ``main/src/init/file_init.hpp``): ``--init dump.h5:<step>``
resumes a run (a negative step counts from the last dump), and
``--init dump.h5,N`` up-samples it N-fold."""

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from sphexa_torch.convert import state_from_numpy
from sphexa_torch.device import resolve_device
from sphexa_torch.dtypes import KEY_BITS
from sphexa_torch.io.snapshot import _find_parts, read_snapshot
from sphexa_torch.sfc.box import Box
from sphexa_torch.sfc.hilbert import hilbert_decode
from sphexa_torch.sfc.keys import compute_sfc_keys
from sphexa_torch.sph.particles import ParticleState, SimConstants


def parse_file_spec(spec: str) -> Tuple[str, int]:
    """Split 'path[:step]'; the step defaults to -1 (the last dump)."""
    path, sep, step = spec.rpartition(":")
    if sep and path and _is_int(step):
        return path, int(step)
    return spec, -1


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def looks_like_file(spec: str) -> bool:
    """An --init argument naming an existing file (with an optional :step)
    or the base path of a sharded dump's part files is a restart."""
    path, _ = parse_file_spec(spec)
    return os.path.exists(path) or bool(_find_parts(path))


def init_from_file(spec: str, side: Optional[int] = None, device=None
                   ) -> Tuple[ParticleState, Box, SimConstants]:
    """Restore (state, box, const) from 'path[:step]'; ``side`` is accepted
    and ignored, so the signature matches the generated cases."""
    path, step = parse_file_spec(spec)
    state, box, const, _extra = read_snapshot(path, step=step, device=device)
    return state, box, const


def parse_split_spec(spec: str):
    """'path,N' (the reference's file-split grammar, factory.hpp:101) ->
    (path, N), or None when the spec has no ',N'."""
    path, sep, num = spec.rpartition(",")
    if sep and path and _is_int(num) and int(num) >= 1:
        return path, int(num)
    return None


def init_file_split(path: str, num_splits: int, side: Optional[int] = None, device=None
                    ) -> Tuple[ParticleState, Box, SimConstants]:
    """Up-sample the last snapshot of ``path`` by an integer split factor
    (file_init.hpp FileSplitInit:105-246): each particle spawns
    ``num_splits`` particles, itself and positions at evenly spaced SFC
    keys toward the next particle's key, with m/N, h/N^(1/3) and the
    other fields replicated; the clock restarts (ttot 0) with minDt
    reduced by 100 N. The arithmetic is the JAX package's, in numpy on
    the host (the keys decoded by the port's Hilbert codec), so the keys
    and positions agree bit for bit."""
    if num_splits < 1:
        raise ValueError(
            f"number of particle splits must be a positive integer (got {num_splits})")
    state, box, const, _extra = read_snapshot(path, step=-1, device="cpu")
    n0 = state.n

    keys = compute_sfc_keys(state.x, state.y, state.z, box).numpy().astype(np.uint64)
    order = np.argsort(keys)
    keys = keys[order]

    def sorted_np(a):
        return a.numpy()[order]

    x0, y0, z0 = sorted_np(state.x), sorted_np(state.y), sorted_np(state.z)

    # interpolated keys between consecutive particles (file_init.hpp:184-195:
    # the last particle interpolates backward)
    key_next = np.empty_like(keys)
    key_next[:-1] = keys[1:]
    key_next[-1] = keys[-1] - (keys[-1] - keys[-2]) if n0 > 1 else keys[-1]
    denom = np.full(n0, num_splits, dtype=np.int64)
    denom[-1] += 1
    delta = (key_next.astype(np.int64) - keys.astype(np.int64)) // denom

    n1 = n0 * num_splits
    xs, ys, zs = (np.empty(n1, np.float32) for _ in range(3))
    xs[::num_splits], ys[::num_splits], zs[::num_splits] = x0, y0, z0
    lo = np.asarray([float(box.lo[0]), float(box.lo[1]), float(box.lo[2])])
    lengths = box.lengths.numpy()
    max_coord = float(1 << KEY_BITS)
    for j in range(1, num_splits):
        kj = (keys.astype(np.int64) + j * delta).astype(np.uint64)
        ix, iy, iz = (a.numpy() for a in hilbert_decode(torch.as_tensor(kj.astype(np.int64))))
        xs[j::num_splits] = lo[0] + ix * lengths[0] / max_coord
        ys[j::num_splits] = lo[1] + iy * lengths[1] / max_coord
        zs[j::num_splits] = lo[2] + iz * lengths[2] / max_coord

    def replicate(field, scale=1.0):
        return np.repeat(sorted_np(field) * scale, num_splits)

    inv_cbrt = float(num_splits) ** (-1.0 / 3.0)
    min_dt = float(state.min_dt) / (100.0 * num_splits)
    vx, vy, vz = replicate(state.vx), replicate(state.vy), replicate(state.vz)
    zeros = np.zeros(n1, np.float32)
    fields = {
        "x": xs, "y": ys, "z": zs, "vx": vx, "vy": vy, "vz": vz,
        "m": replicate(state.m, 1.0 / num_splits), "h": replicate(state.h, inv_cbrt),
        "temp": replicate(state.temp), "temp_lo": zeros, "alpha": replicate(state.alpha),
        "du": zeros, "du_m1": zeros,
        "x_m1": vx * min_dt, "y_m1": vy * min_dt, "z_m1": vz * min_dt,
        "ttot": np.float32(0.0), "min_dt": np.float32(min_dt), "min_dt_m1": np.float32(min_dt),
    }
    b = {"lo": box.lo.numpy(), "hi": box.hi.numpy(), "boundaries": box.boundaries}
    return state_from_numpy(fields, b, dataclasses.asdict(const), resolve_device(device))
