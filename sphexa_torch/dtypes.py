"""Dtype policy of the port (counterpart of sphexa_tpu/dtypes.py).

- SFC keys: 30-bit values (10 octree levels x 3 bits) held in int64.
  torch's uint32 coverage (shifts, comparisons, sort) is partial, and the
  key values never reach the sign bit, so int64 orders them exactly as
  the JAX package's uint32 keys.
- coordinates and hydro fields: float32.
"""

import torch

KEY_DTYPE = torch.int64
KEY_BITS = 10  # octree levels encodable in a key
KEY_MAX = 1 << (3 * KEY_BITS)

COORD_DTYPE = torch.float32
HYDRO_DTYPE = torch.float32
INDEX_DTYPE = torch.int32

#: JXA101 (devtools/audit): the deliberate float64 sites on the device, by
#: ``file:function`` (the innermost function of the repository that makes
#: the value), each with its reason. A float64 value made anywhere else is
#: a finding.
F64_SITES = {
    "sphexa_torch/gravity/multipole.py:edge_segment_sum":
        "segment sums as differences of exact float64 prefix sums, rounded to "
        "float32: the same bits on every device and in every order (the "
        "multipole upsweep, the snapshot deposit)",
    "sphexa_torch/gravity/traversal.py:rank_sums":
        "a rank's float64 segment sums of the sharded upsweep, summed over the "
        "ranks before the one rounding",
    "sphexa_torch/observables/conserved.py:conserved_sums":
        "the ledger's conserved sums accumulate in float64 on the device, as "
        "the JAX package's do",
    "sphexa_torch/observables/conserved.py:conserved_from_sums":
        "the energies and momenta formed from the float64 sums",
    "sphexa_torch/neighbors/cell_list.py:_fma":
        "the gather search's squared distance: float32 products exact in "
        "float64, one rounding (the JAX search's fused multiply-add)",
    "sphexa_torch/neighbors/cell_list.py:_search_windows":
        "the gather search's pair work, summed exactly",
    "sphexa_torch/neighbors/cell_list.py:slab_group_bounds":
        "a rank's group bounds packed with its key range into one float64 row",
    "sphexa_torch/parallel/mesh.py:reduce_scalars":
        "the cross-rank scalar sums, added in rank order in float64 (integers "
        "exact up to 2^53)",
    "sphexa_torch/propagator.py:_step_diagnostics":
        "the mean neighbour count from an int64 sum",
    "sphexa_torch/propagator.py:_gravity_sharded_stage":
        "the sharded gravity's work sums",
    "sphexa_torch/propagator.py:_shard_tail": "the sharded step's work sums",
    "sphexa_torch/propagator.py:_std_forces_sharded": "the sharded pair work sum",
    "sphexa_torch/propagator.py:_ve_forces_sharded": "the sharded pair work sum",
    "sphexa_torch/simulation.py:_launch":
        "a window's scalars packed into one float64 vector for its one read",
    "sphexa_torch/sph/pair_engine.py:eta_crit":
        "av_clean's cube root rounded from float64, as XLA's cbrt",
}

#: JXA101: the int64 leaves an entry may return (its other integers are
#: INDEX_DTYPE), by key, each with its reason
INT64_OUTPUTS = {
    "nc_sum": "the step's neighbour-count sum: N x ng exceeds 2^31 from some "
              "10^7 particles",
    "occupancy": "the densest cell's count, from searchsorted's int64 cell ranges: "
                 "a cast to int32 would cost one more kernel a step",
}
