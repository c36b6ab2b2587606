"""Particle state and simulation constants (sphexa_tpu/sph/particles.py)."""

import dataclasses
from typing import Optional

import torch

from sphexa_torch.dtypes import HYDRO_DTYPE
from sphexa_torch.sph.kernels import kernel_norm_3d

#: per-particle fields of ParticleState, in declaration order
PARTICLE_FIELDS = ("x", "y", "z", "x_m1", "y_m1", "z_m1", "vx", "vy", "vz",
                   "h", "m", "temp", "temp_lo", "du", "du_m1", "alpha")
#: 0-d float32 integrator scalars of ParticleState
SCALAR_FIELDS = ("ttot", "min_dt", "min_dt_m1")


@dataclasses.dataclass
class ParticleState:
    """Conserved per-particle fields (1-D float32) and the integrator
    scalars (0-d float32 tensors, never Python floats: the position and
    energy updates must stay in float32 as in the JAX package).
    ``temp_lo`` is the two-sum carry of the energy update."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    x_m1: torch.Tensor
    y_m1: torch.Tensor
    z_m1: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor
    temp: torch.Tensor
    temp_lo: torch.Tensor
    du: torch.Tensor
    du_m1: torch.Tensor
    alpha: torch.Tensor
    ttot: torch.Tensor
    min_dt: torch.Tensor
    min_dt_m1: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[0]

    def to(self, device) -> "ParticleState":
        return ParticleState(**{f.name: getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)})


R_GAS = 8.317e7  # universal gas constant in cgs (sph/eos.hpp:16)


def ideal_gas_cv(mui: float, gamma: float) -> float:
    """Heat capacity for mean molecular weight mui (sph/eos.hpp:13-18)."""
    return R_GAS / mui / (gamma - 1.0)


@dataclasses.dataclass(frozen=True)
class SimConstants:
    """Static physics constants (particles_data.hpp:89-138 defaults).

    ``sym_pairs``: the momentum/energy ops also require d < 2 h_j, which
    makes the pair forces exactly antisymmetric (the JAX package's default).
    """

    ng0: int = 100
    ngmax: int = 150
    k_cour: float = 0.2
    k_rho: float = 0.06
    gamma: float = 5.0 / 3.0
    mui: float = 10.0
    alphamin: float = 0.05
    alphamax: float = 1.0
    decay_constant: float = 0.2
    at_min: float = 0.1
    at_max: float = 0.2
    g: float = 0.0
    eps: float = 0.005
    eta_acc: float = 0.2
    max_dt_increase: float = 1.1
    sinc_index: float = 6.0
    sym_pairs: bool = True
    kernel_choice: str = "sinc"
    kernel_norm: Optional[float] = None

    @property
    def ramp(self) -> float:
        """Slope of the VE momentum op's Atwood ramp between at_min and at_max."""
        return 1.0 / (self.at_max - self.at_min)

    @property
    def cv(self) -> float:
        return ideal_gas_cv(self.mui, self.gamma)

    @property
    def K(self) -> float:
        if self.kernel_norm is None:
            raise ValueError("use SimConstants.normalized() to fill kernel_norm")
        return self.kernel_norm

    def normalized(self) -> "SimConstants":
        """A copy with the kernel normalization constant computed."""
        if self.kernel_norm is not None:
            return self
        return dataclasses.replace(
            self, kernel_norm=kernel_norm_3d(self.sinc_index, self.kernel_choice)
        )

    def with_kernel(self, kind: str, sinc_index: Optional[float] = None) -> "SimConstants":
        """A copy with another SPH kernel (the CLI's --kernel and
        --sincIndex; None keeps the index): the choice, the index and the
        normalization recomputed for them."""
        n = self.sinc_index if sinc_index is None else sinc_index
        return dataclasses.replace(self, kernel_choice=kind, sinc_index=n,
                                   kernel_norm=kernel_norm_3d(n, kind))


def scalar(v, device) -> torch.Tensor:
    """A 0-d float32 tensor (integrator scalars)."""
    return torch.tensor(v, dtype=HYDRO_DTYPE, device=device)
