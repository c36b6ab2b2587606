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
    """The energies and the norms of the linear and angular momentum, as
    0-d float64 device tensors. One (9, N) float32 stack of products is
    summed in float64: the kinetic and internal energy rows, the two-sum
    carry ``temp_lo`` in a row of its own (added per element it would
    round away again), and the momentum components. The step's ledger
    (``ledger.ledger_diagnostics``) takes its energies from here."""
    return conserved_from_sums(conserved_sums(state, const), egrav)


def conserved_sums(state: ParticleState, const: SimConstants) -> torch.Tensor:
    """The (9,) float64 sums ``conserved_quantities`` is made of (under a
    mesh each rank's, summed over the ranks before ``conserved_from_sums``)."""
    m = state.m
    mv3 = m * torch.stack([state.vx, state.vy, state.vz])
    rows = torch.cat([
        (m * (state.vx**2 + state.vy**2 + state.vz**2))[None],
        (const.cv * state.temp * m)[None],
        (const.cv * state.temp_lo * m)[None],
        mv3,
        torch.linalg.cross(torch.stack([state.x, state.y, state.z]), mv3, dim=0),
    ])
    return torch.sum(rows, dim=1, dtype=torch.float64)


def conserved_from_sums(s: torch.Tensor, egrav: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
    """The energies and momentum norms from ``conserved_sums``' (9,) sums."""
    f64 = torch.float64
    ekin = 0.5 * s[0]
    eint = s[1] + s[2]
    if egrav is None:
        egrav, etot = torch.zeros((), dtype=f64, device=s.device), ekin + eint
    else:
        egrav = egrav.to(f64)
        etot = ekin + eint + egrav
    mom = torch.linalg.vector_norm(s[3:].view(2, 3), dim=1)
    return {
        "ecin": ekin,
        "eint": eint,
        "egrav": egrav,
        "etot": etot,
        "linmom": mom[0],
        "angmom": mom[1],
    }
