"""Snapshot and checkpoint file I/O (sphexa_tpu/io): HDF5 files with one
``Step#n`` group per dump and the restart metadata as group attributes,
or a one-snapshot ``.npz`` (the only container on a machine without
h5py); the JAX package's layout, so dumps restart in either package."""

from sphexa_torch.io.snapshot import (
    list_steps,
    read_snapshot,
    read_snapshot_full,
    write_ascii,
    write_snapshot,
    write_snapshot_sharded,
)

__all__ = ["write_snapshot", "write_snapshot_sharded", "read_snapshot", "read_snapshot_full",
           "list_steps", "write_ascii"]
