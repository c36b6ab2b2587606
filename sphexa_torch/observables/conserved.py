"""Conserved quantities (sphexa_tpu/observables/conserved.py): energies
and linear/angular momentum. Per-particle products are float32 as in the
JAX package; the sums accumulate in float64 on the device, as the
reference does with x64 enabled. The gravitational energy is the force
stage's device tensor (0-d), so that adding it reads nothing back."""

from typing import Dict, Optional

import torch

from sphexa_torch.sph.particles import ParticleState, SimConstants


def conserved_quantities(state: ParticleState, const: SimConstants,
                         egrav: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    m = state.m
    f64 = torch.float64
    egrav = (torch.zeros((), dtype=f64, device=m.device) if egrav is None
             else egrav.to(f64))

    def total(a):
        return torch.sum(a, dtype=f64)

    ekin = 0.5 * total(m * (state.vx**2 + state.vy**2 + state.vz**2))
    # the two-sum carry is summed separately: added per element it would
    # round away again
    eint = total(const.cv * state.temp * m) + total(const.cv * state.temp_lo * m)
    etot = ekin + eint + egrav
    lin = [total(m * v) for v in (state.vx, state.vy, state.vz)]
    ang = [
        total(m * (state.y * state.vz - state.z * state.vy)),
        total(m * (state.z * state.vx - state.x * state.vz)),
        total(m * (state.x * state.vy - state.y * state.vx)),
    ]
    return {
        "ecin": ekin,
        "eint": eint,
        "egrav": egrav,
        "etot": etot,
        "linmom": torch.sqrt(lin[0] ** 2 + lin[1] ** 2 + lin[2] ** 2),
        "angmom": torch.sqrt(ang[0] ** 2 + ang[1] ** 2 + ang[2] ** 2),
    }
