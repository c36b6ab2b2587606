"""Neighbour-search configuration (sphexa_tpu/neighbors)."""
