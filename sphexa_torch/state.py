"""The simulation carry (sphexa_tpu/state.py).

``SimState`` is the one structure every step maps onto: the particle
state and box that all propagator families share, plus one optional aux
slot per family extension: ``turb`` (turb-ve: the stirring's
TurbulenceState, its phases on the device and its random key on the
host), ``chem`` (std-cooling: the per-particle ChemistryData) and
``bdt`` (block time steps: the BlockDtState of sph/blockdt.py, its bins
riding the step's sort). A plain dataclass: PyTorch has no pytree
registration to port.

The driver builds it once from its attributes and only ever replaces the
active slot, as in the JAX package, whose carry's treedef changes when a
slot flips between None and a value.
"""

import dataclasses
from typing import Any, Optional

__all__ = ["SimState", "AUX_SLOTS"]

#: family-extension slots, in carry order (turb-ve / std-cooling /
#: block time steps); at most one is set for a given propagator family
AUX_SLOTS = ("turb", "chem", "bdt")


@dataclasses.dataclass
class SimState:
    """What one step consumes and (diagnostics aside) produces."""

    particles: Any                 # sph.particles.ParticleState
    box: Any                       # sfc.box.Box
    turb: Optional[Any] = None
    chem: Optional[Any] = None
    bdt: Optional[Any] = None

    def with_slot(self, slot: Optional[str], value: Any,
                  particles: Any = None, box: Any = None) -> "SimState":
        """Copy with the named aux slot (and optionally particles/box)
        replaced; ``slot=None`` replaces particles/box only."""
        kw = {}
        if particles is not None:
            kw["particles"] = particles
        if box is not None:
            kw["box"] = box
        if slot is not None:
            kw[slot] = value
        return dataclasses.replace(self, **kw)
