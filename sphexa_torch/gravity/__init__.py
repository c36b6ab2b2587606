"""Barnes-Hut self-gravity (sphexa_tpu/gravity): the linked octree, the
multipole upsweep (cartesian quadrupoles, or spherical multipoles of order
P), the monotone-MAC classification with its two list compactions, the far
field (M2P), the near field (P2P) through the K12 kernel, and periodic
boxes through Ewald summation (replica passes plus the root multipole's
real-space and k-space corrections)."""
