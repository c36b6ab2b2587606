"""Cornerstone octrees (sphexa_tpu/tree): the sorted-key leaf array
(node i spans [tree[i], tree[i + 1])), counts by searchsorted, the
count-and-rebalance build, key injection, the continuum build from an
analytic density, and the SFC domain decomposition."""

from sphexa_torch.tree.continuum import compute_continuum_octree, continuum_counts
from sphexa_torch.tree.csarray import (
    compute_node_counts,
    compute_octree,
    make_root_tree,
    make_uniform_tree,
    node_levels,
    rebalance_tree,
    update_octree,
)
from sphexa_torch.tree.decomposition import make_sfc_assignment, uniform_bins
from sphexa_torch.tree.inject import inject_keys

__all__ = [
    "compute_node_counts",
    "compute_octree",
    "make_root_tree",
    "make_uniform_tree",
    "node_levels",
    "rebalance_tree",
    "update_octree",
    "make_sfc_assignment",
    "uniform_bins",
    "compute_continuum_octree",
    "continuum_counts",
    "inject_keys",
]
