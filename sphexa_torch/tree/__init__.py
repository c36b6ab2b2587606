"""Octree helpers (sphexa_tpu/tree, the parts the gravity tree reads)."""
