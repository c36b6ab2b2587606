"""Turbulence stirring (sphexa_tpu/sph/hydro_turb.py): an Ornstein-Uhlenbeck
process drives a fixed set of Fourier modes whose Helmholtz
(solenoidal/compressive) projection accelerates the gas (Eswaran & Pope
1988 forcing, Mach-controlled; the reference's sph/hydro_turb/).

The OU stream is the JAX package's: its state carries a JAX PRNG key,
which the port carries as the same uint32 pair on the host and advances
with sph/threefry.py. Each step's draw is made on the host and goes to
the phases' device with one copy (from pinned memory on the card, so it
reads nothing back and waits for nothing); the damping, which depends on
the step's dt, and everything after it run on the device. The stirring
sum over the modes is the JAX package's two (N, M) @ (M, 3) products of
the cosines and sines of the phase matrix.
"""

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from sphexa_torch.sph import threefry
from sphexa_torch.util.phases import named_phase

__all__ = ["TurbulenceConfig", "TurbulenceState", "create_stirring_modes", "update_noise",
           "compute_phases", "st_calc_accel", "drive_turbulence",
           "turbulence_state_to_fields", "turbulence_state_from_fields"]


@dataclasses.dataclass(frozen=True)
class TurbulenceConfig:
    """Static stirring parameters (turbulence_data.hpp:57-71,155-175)."""

    num_modes: int
    sol_weight: float
    sol_weight_norm: float
    decay_time: float
    variance: float
    ndim: int = 3


@dataclasses.dataclass
class TurbulenceState:
    """The stirring state: the fixed mode table, the OU phases and the
    random key (the reference checkpoints the phases and its mt19937 the
    same way, turbulence_data.hpp:88-100)."""

    modes: torch.Tensor       # (M, 3) wave vectors, float32
    amplitudes: torch.Tensor  # (M,) spectrum amplitudes, float32
    phases: torch.Tensor      # (M, 3, 2) OU phases, [..., 0] real, [..., 1] imaginary
    key: np.ndarray           # the JAX PRNG key, uint32 (2,), on the host

    def to(self, device) -> "TurbulenceState":
        return dataclasses.replace(self, modes=self.modes.to(device),
                                   amplitudes=self.amplitudes.to(device),
                                   phases=self.phases.to(device))


def create_stirring_modes(
    lbox: float, st_max_modes: int = 100000, energy_prefac: float = 5.0e-3,
    mach_velocity: float = 0.3, sol_weight: float = 0.5, spect_form: int = 1,
    ndim: int = 3, seed: int = 251299, eps: float = 1e-15,
    power_law_exp: float = 5.0 / 3.0, angles_exp: float = 2.0, device="cpu",
) -> Tuple[TurbulenceConfig, TurbulenceState]:
    """The stirring mode table and the initial OU state, built in float64
    numpy as the JAX package builds them: the stirring band k in
    [2 pi/L, 3 2 pi/L], a band (spect_form 0), parabolic (1) or power-law
    random-angle (2, create_modes.hpp:179-238) spectrum, the mirrored
    +-ky/+-kz modes (create_modes.hpp:30-160), the OU variance from the
    target Mach energy input rate; the initial phases are the variance
    times a normal draw of the key's first split."""
    if spect_form not in (0, 1, 2):
        raise ValueError("spect_form must be 0 (band), 1 (parabolic) or 2 (power law)")
    twopi = 2.0 * np.pi
    velocity = mach_velocity
    energy = energy_prefac * velocity**3 / lbox
    stir_min = (1.0 - eps) * twopi / lbox
    stir_max = (3.0 + eps) * twopi / lbox
    decay_time = lbox / (2.0 * velocity)
    variance = np.sqrt(energy / decay_time)
    sol_weight_norm = (np.sqrt(3.0) * np.sqrt(3.0 / ndim)
                       / np.sqrt(1.0 - 2.0 * sol_weight + ndim * sol_weight**2))

    kc = 0.5 * (stir_min + stir_max) if spect_form == 1 else stir_min
    parab_prefact = -4.0 / (stir_max - stir_min) ** 2

    ik_max = int(np.ceil(stir_max / twopi * lbox)) + 1
    modes, amplitudes = [], []
    if spect_form == 2:
        # power-law spectrum, random-angle shell sampling: nang ~ 2^ndim
        # ceil(ik^anglesExp) directions per k-shell, amplitude
        # (k/kc)^powerLawExp with the angle-count correction; the
        # reference's pow(k/kc, +powerLawExp) (create_modes.hpp:222) as is
        rng = np.random.default_rng(seed)
        ik_min = max(1, int(stir_min * lbox / twopi + 0.5))
        ik_hi = int(stir_max * lbox / twopi + 0.5)
        for ik in range(ik_min, ik_hi + 1):
            nang = int(2**ndim * np.ceil(ik**angles_exp))
            for _ in range(nang):
                phi = twopi * rng.uniform()
                theta = np.arccos(1.0 - 2.0 * rng.uniform()) if ndim > 2 else 0.5 * np.pi
                rand = ik + rng.uniform() - 0.5
                kx = twopi * np.round(rand * np.sin(theta) * np.cos(phi)) / lbox
                ky = (twopi * np.round(rand * np.sin(theta) * np.sin(phi)) / lbox
                      if ndim > 1 else 0.0)
                kz = twopi * np.round(rand * np.cos(theta)) / lbox if ndim > 2 else 0.0
                k = np.sqrt(kx**2 + ky**2 + kz**2)
                if not stir_min <= k <= stir_max:
                    continue
                amp = (k / kc) ** power_law_exp
                amp = (np.sqrt(amp * (ik ** (ndim - 1) * 4.0 * np.sqrt(3.0) / nang))
                       * (kc / k) ** (0.5 * (ndim - 1)))
                modes.append((kx, ky, kz))
                amplitudes.append(amp)
                if len(modes) > st_max_modes:
                    raise ValueError(f"too many stirring modes ({len(modes)} > {st_max_modes})")
    else:
        for ikx in range(0, ik_max + 1):
            kx = twopi * ikx / lbox
            for iky in range(0, ik_max + 1 if ndim > 1 else 1):
                ky = twopi * iky / lbox
                for ikz in range(0, ik_max + 1 if ndim > 2 else 1):
                    kz = twopi * ikz / lbox
                    k = np.sqrt(kx**2 + ky**2 + kz**2)
                    if not stir_min <= k <= stir_max:
                        continue
                    amp = 1.0
                    if spect_form == 1:
                        amp = abs(parab_prefact * (k - kc) ** 2 + 1.0)
                    amp = 2.0 * np.sqrt(amp) * (kc / k) ** (0.5 * (ndim - 1))
                    # the mirrored sign combinations of ky/kz cover the
                    # half-space of independent modes
                    signsets = [(kx, ky, kz)]
                    if ndim > 1:
                        signsets.append((kx, -ky, kz))
                    if ndim > 2:
                        signsets += [(kx, ky, -kz), (kx, -ky, -kz)]
                    for kvec in signsets:
                        modes.append(kvec)
                        amplitudes.append(amp)
                    if len(modes) > st_max_modes:
                        raise ValueError(
                            f"too many stirring modes ({len(modes)} > {st_max_modes})")

    m = len(modes)
    cfg = TurbulenceConfig(num_modes=m, sol_weight=sol_weight,
                           sol_weight_norm=float(sol_weight_norm),
                           decay_time=float(decay_time), variance=float(variance), ndim=ndim)
    key, sub = threefry.split(threefry.prng_key(seed))
    phases = np.float32(variance) * threefry.normal(sub, (m, 3, 2))
    state = TurbulenceState(
        modes=torch.as_tensor(np.asarray(modes, np.float32), device=device),
        amplitudes=torch.as_tensor(np.asarray(amplitudes, np.float32), device=device),
        phases=torch.as_tensor(phases, device=device), key=key)
    return cfg, state


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` with no wait: on the card one copy from
    pinned memory, queued behind the step's kernels."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def update_noise(turb: TurbulenceState, dt: torch.Tensor,
                 cfg: TurbulenceConfig) -> TurbulenceState:
    """One OU step: x' = f x + sigma sqrt(1 - f^2) z, f = exp(-dt/ts)
    (driver.hpp:43-91, Bartosch 2001); z is the normal draw of the key's
    second split, and the key moves to its first."""
    damping_a = torch.exp(-dt / cfg.decay_time)
    damping_b = torch.sqrt(1.0 - damping_a ** 2)
    key, sub = threefry.split(turb.key)
    z = _to_device(threefry.normal(sub, tuple(turb.phases.shape)), turb.phases.device)
    phases = turb.phases * damping_a + cfg.variance * damping_b * z
    return dataclasses.replace(turb, phases=phases, key=key)


def compute_phases(turb: TurbulenceState, cfg: TurbulenceConfig):
    """Helmholtz projection of the OU phases: the solenoidal weight sw
    blends the curl (divergence-free) and div (compressive) parts of each
    mode (phases.hpp:45-71). Returns (phases_real, phases_imag), each (M, 3)."""
    k = turb.modes
    ph_re = turb.phases[..., 0]
    ph_im = turb.phases[..., 1]
    kk = torch.sum(k * k, dim=1, keepdim=True)
    ka = torch.sum(k * ph_im, dim=1, keepdim=True)
    kb = torch.sum(k * ph_re, dim=1, keepdim=True)
    diva = k * ka / kk
    divb = k * kb / kk
    curla = ph_re - divb
    curlb = ph_im - diva
    sw = cfg.sol_weight
    return sw * curla + (1.0 - sw) * divb, sw * curlb + (1.0 - sw) * diva


def st_calc_accel(x, y, z, turb: TurbulenceState, cfg: TurbulenceConfig,
                  phases_real, phases_imag):
    """Stirring accelerations a_i = norm sum_m amp_m Re[P_m e^{i k_m x_i}]
    (stirring.hpp stirParticle), as the (N, M) @ (M, 3) products of the
    JAX package, in float32."""
    k = turb.modes
    kdotx = x[:, None] * k[None, :, 0] + y[:, None] * k[None, :, 1] + z[:, None] * k[None, :, 2]
    ck = torch.cos(kdotx)
    sk = torch.sin(kdotx)
    amp_pr = turb.amplitudes[:, None] * phases_real
    amp_pi = turb.amplitudes[:, None] * phases_imag
    acc = cfg.sol_weight_norm * (ck @ amp_pr - sk @ amp_pi)
    return acc[:, 0], acc[:, 1], acc[:, 2]


@named_phase("turbulence")
def drive_turbulence(x, y, z, ax, ay, az, dt, turb: TurbulenceState, cfg: TurbulenceConfig):
    """The OU update, the projection and the stirring added to the
    accelerations, one step (driver.hpp:104-130). Returns (ax, ay, az,
    the advanced TurbulenceState)."""
    turb = update_noise(turb, dt, cfg)
    pr, pi = compute_phases(turb, cfg)
    tx, ty, tz = st_calc_accel(x, y, z, turb, cfg, pr, pi)
    return ax + tx, ay + ty, az + tz, turb


def turbulence_state_to_fields(turb: TurbulenceState,
                               cfg: TurbulenceConfig) -> Dict[str, np.ndarray]:
    """The stirring state and the config's scalars as the JAX package's
    dump datasets (turb_modes, turb_amplitudes, turb_phases float32,
    turb_key uint32, turb_cfg float64): a restart resumes the same forcing."""
    return {
        "turb_modes": turb.modes.cpu().numpy(),
        "turb_amplitudes": turb.amplitudes.cpu().numpy(),
        "turb_phases": turb.phases.cpu().numpy(),
        "turb_key": np.asarray(turb.key, np.uint32),
        "turb_cfg": np.asarray([cfg.sol_weight, cfg.sol_weight_norm, cfg.decay_time,
                                cfg.variance, float(cfg.ndim)], np.float64),
    }


def turbulence_state_from_fields(fields: Dict[str, np.ndarray], device="cpu"
                                 ) -> Tuple[TurbulenceState, TurbulenceConfig]:
    """Inverse of turbulence_state_to_fields (the restart path)."""
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    state = TurbulenceState(modes=f32(fields["turb_modes"]),
                            amplitudes=f32(fields["turb_amplitudes"]),
                            phases=f32(fields["turb_phases"]),
                            key=np.asarray(fields["turb_key"], np.uint32).copy())
    sw, swn, ts, var, ndim = (float(v) for v in fields["turb_cfg"])
    cfg = TurbulenceConfig(num_modes=state.modes.shape[0], sol_weight=sw, sol_weight_norm=swn,
                           decay_time=ts, variance=var, ndim=int(ndim))
    return state, cfg
