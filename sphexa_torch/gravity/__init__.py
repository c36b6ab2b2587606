"""Barnes-Hut self-gravity (sphexa_tpu/gravity, open boxes, cartesian
quadrupoles): the linked octree, the multipole upsweep, the monotone-MAC
classification with its two list compactions, the far field (M2P) and the
near field (P2P) through the pair engine."""
