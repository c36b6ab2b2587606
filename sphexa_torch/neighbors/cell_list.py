"""Static cell-grid configuration of the neighbour search
(sphexa_tpu/neighbors/cell_list.py, the parts the pair engine reads; the
XLA gather path ``find_neighbors`` is not ported)."""

import dataclasses
import functools

import numpy as np

from sphexa_torch.dtypes import KEY_BITS


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    """Static configuration of the neighbour search: the fields of the JAX
    package's NeighborConfig that the pair engine reads, with their names
    and meaning. Runs are always merged (``run_cap > 0``)."""

    level: int  # octree level of the cell grid
    cap: int  # max particles counted per cell
    curve: str = "hilbert"
    group: int = 64  # targets per group
    window: int = 4  # cells per dimension of the group candidate block
    run_cap: int = 1536  # merged-run length cap
    gap: int = 384  # key-space gap a run may bridge

    def __post_init__(self):
        if self.run_cap <= 0:
            raise ValueError(f"run_cap must be positive, got {self.run_cap}")


def choose_grid_level(box_lengths, h_max: float) -> int:
    """Deepest grid level whose cell edge still covers the 2h radius."""
    min_extent = float(np.min(np.asarray(box_lengths)))
    if h_max <= 0:
        return KEY_BITS
    level = int(np.floor(np.log2(min_extent / (2.0 * h_max))))
    return max(1, min(KEY_BITS, level))


def pad_cap(occ: int, margin: float = 1.3, quantum: int = 8) -> int:
    """Pad an observed max cell occupancy into a static cap."""
    return max(quantum, int(np.ceil(occ * margin / quantum) * quantum))


def window_cells(ext: float, radius: float, edge: float, ncell: int,
                 margin_cells: int = 1) -> int:
    """Cells needed along one dimension to cover a group extent plus the
    search radius, clamped to the grid."""
    return min(int(np.ceil((ext + radius) / edge)) + 1 + margin_cells, ncell)


@functools.lru_cache(maxsize=None)
def _window_offsets(window: int) -> np.ndarray:
    """(window^3, 3) int32 offsets of the group candidate cell block."""
    r = np.arange(window, dtype=np.int32)
    return np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
