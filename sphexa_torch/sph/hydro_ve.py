"""VE equation of state and the gather backend's VE ops
(sphexa_tpu/sph/hydro_ve.py): xmass, ve_def_gradh, divv/curlv (with or
without the av_clean velocity gradient), the AV switches and
momentum/energy, masked j-reductions over the (N, ngmax) lists of
``neighbors.cell_list.find_neighbors``; the IAD op is the std one
(hydro_std.compute_iad with vol_j = xm / kx). The pair engine's VE ops
are the fused search+op kernels of sph/pair_engine.py. The targets are the
list's rows; the fields an op reads on the j side may be j-buffers [own
slab | halo rows] (sph/pairs.py), ``nc`` is the targets' own."""

import torch

from sphexa_torch.sfc.box import Box
from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.hydro_std import kernel_w, op_block, sym_mask
from sphexa_torch.sph.kernels import artificial_viscosity, sinc_dterh_u, ts_k_courant
from sphexa_torch.sph.pairs import iad_project, mmax, msum, pair_geometry
from sphexa_torch.sph.particles import SimConstants
from sphexa_torch.util.blocking import blocked_map
from sphexa_torch.util.phases import named_phase


def compute_eos_ve(temp: torch.Tensor, m: torch.Tensor, kx: torch.Tensor,
                   xm: torch.Tensor, gradh: torch.Tensor, const: SimConstants):
    """VE ideal-gas EOS (hydro_ve/eos.hpp:52-77): returns (prho, c, rho, p),
    where prho = p / (kx m^2 gradh) enters the momentum sum."""
    rho = kx * m / xm
    tmp = const.cv * temp * (const.gamma - 1.0)
    p = rho * tmp
    c = torch.sqrt(tmp)
    prho = p / (kx * m * m * gradh)
    return prho, c, rho, p


@named_phase("xmass")
def compute_xmass(x, y, z, h, m, nidx, nmask, box: Box, const: SimConstants,
                  block: int = 2048):
    """The volume element xm_i = m_i / rho0_i (xmass_kern.hpp:50-79)."""
    def body(idx):
        g = pair_geometry(idx, x, y, z, h, nidx, nmask, box)
        rho0 = m[idx] + msum(g.mask, m[g.nj] * kernel_w(g.v1 * g.v1, const))
        h_i = h[idx]
        return m[idx] / (rho0 * const.K / (h_i * h_i * h_i))

    return blocked_map(body, nidx.shape[0], op_block(block, nidx, "density"), x.device)


@named_phase("gradh")
def compute_ve_def_gradh(x, y, z, h, m, xm, nidx, nmask, box: Box, const: SimConstants,
                         block: int = 2048):
    """The VE normalization kx and the grad-h correction
    (ve_def_gradh_kern.hpp:43-90). Returns (kx, gradh)."""
    def body(idx):
        g = pair_geometry(idx, x, y, z, h, nidx, nmask, box)
        u = g.v1 * g.v1
        w = kernel_w(u, const)
        dterh = sinc_dterh_u(u, const.sinc_index, const.kernel_choice)
        xm_i, m_i, h_i = xm[idx], m[idx], h[idx]
        kx = xm_i + msum(g.mask, xm[g.nj] * w)
        whomega = -3.0 * xm_i + msum(g.mask, xm[g.nj] * dterh)
        wrho0 = -3.0 * m_i + msum(g.mask, m[g.nj] * dterh)
        h3inv = 1.0 / (h_i * h_i * h_i)
        kx = kx * const.K * h3inv
        whomega = whomega * const.K * h3inv / h_i
        wrho0 = wrho0 * const.K * h3inv / h_i
        whomega = whomega * m_i / xm_i + (kx - const.K * xm_i * h3inv) * wrho0
        rho = kx * m_i / xm_i
        dhdrho = -h_i / (rho * 3.0)
        return kx, 1.0 - dhdrho * whomega

    return blocked_map(body, nidx.shape[0], op_block(block, nidx, "iad"), x.device)


@named_phase("divv-curlv")
def compute_iad_divv_curlv(x, y, z, vx, vy, vz, h, kx, xm, c11, c12, c13, c22, c23, c33,
                           nidx, nmask, box: Box, const: SimConstants, block: int = 2048,
                           with_gradv: bool = False):
    """Velocity divergence and curl through the IAD gradient
    (divv_curlv_kern.hpp:43-120); with ``with_gradv`` also the six
    symmetrized velocity-gradient terms of av_clean. Returns (divv, curlv)
    or (divv, curlv, dv11, dv12, dv13, dv22, dv23, dv33)."""
    def body(idx):
        g = pair_geometry(idx, x, y, z, h, nidx, nmask, box)
        w = kernel_w(g.v1 * g.v1, const)
        ci = [a[idx][:, None] for a in (c11, c12, c13, c22, c23, c33)]
        tA = iad_project(*ci, g.rx, g.ry, g.rz, w)
        xm_j = xm[g.nj]
        dv = [[msum(g.mask, (v[g.nj] - v[idx][:, None]) * xm_j * t) for t in tA]
              for v in (vx, vy, vz)]
        dvx, dvy, dvz = dv
        h_i = h[idx]
        norm_kxi = const.K / (h_i * h_i * h_i) / kx[idx]
        divv = norm_kxi * (dvx[0] + dvy[1] + dvz[2])
        curl = (dvz[1] - dvy[2], dvx[2] - dvz[0], dvy[0] - dvx[1])
        curlv = norm_kxi * torch.sqrt(curl[0] ** 2 + curl[1] ** 2 + curl[2] ** 2)
        if with_gradv:
            return (divv, curlv, norm_kxi * dvx[0], norm_kxi * (dvx[1] + dvy[0]),
                    norm_kxi * (dvx[2] + dvz[0]), norm_kxi * dvy[1],
                    norm_kxi * (dvy[2] + dvz[1]), norm_kxi * dvz[2])
        return divv, curlv

    return blocked_map(body, nidx.shape[0], op_block(block, nidx, "iad"), x.device)


@named_phase("av-switches")
def compute_av_switches(x, y, z, vx, vy, vz, h, c, kx, xm, divv, alpha,
                        c11, c12, c13, c22, c23, c33,
                        nidx, nmask, box: Box, dt, const: SimConstants, block: int = 2048):
    """The viscosity switches' evolution (av_switches_kern.hpp:43-137):
    alpha grows toward alphamax in converging flow with a strong
    grad(divv), and decays toward alphamin on the signal-velocity time
    scale otherwise."""
    def body(idx):
        g = pair_geometry(idx, x, y, z, h, nidx, nmask, box)
        h_i = h[idx]
        w = const.K / (h_i * h_i * h_i)[:, None] * kernel_w(g.v1 * g.v1, const)
        rv = (g.rx * (vx[idx][:, None] - vx[g.nj]) + g.ry * (vy[idx][:, None] - vy[g.nj])
              + g.rz * (vz[idx][:, None] - vz[g.nj]))
        c_i = c[idx][:, None]
        vsig_pair = torch.where(rv < 0.0, c_i + c[g.nj] - 3.0 * rv / g.dist, 0.0)
        vijsignal = torch.maximum(mmax(g.mask, vsig_pair), 1e-40 * c[idx])

        ci = [a[idx][:, None] for a in (c11, c12, c13, c22, c23, c33)]
        tA1, tA2, tA3 = iad_project(*ci, g.rx, g.ry, g.rz, w)
        factor = xm[g.nj] / kx[g.nj] * (divv[idx][:, None] - divv[g.nj])
        gdx = msum(g.mask, factor * tA1)
        gdy = msum(g.mask, factor * tA2)
        gdz = msum(g.mask, factor * tA3)
        graddivv = torch.sqrt(gdx * gdx + gdy * gdy + gdz * gdz)

        divv_i = divv[idx]
        a_const = h_i * h_i * graddivv
        alphaloc = torch.where(
            divv_i < 0.0,
            const.alphamax * a_const / (a_const + h_i * torch.abs(divv_i) + 0.05 * c[idx]),
            0.0)
        alpha_i = alpha[idx]
        decay = h_i / (const.decay_constant * vijsignal)
        target = torch.where(alphaloc >= const.alphamin, alphaloc, const.alphamin)
        alpha_decayed = alpha_i + (target - alpha_i) / decay * dt
        return torch.where(alphaloc >= alpha_i, alphaloc, alpha_decayed)

    return blocked_map(body, nidx.shape[0], op_block(block, nidx, "iad"), x.device)


def av_rv_correction(rx, ry, rz, eta_ab, eta_crit, gv_i, gv_j):
    """The av_clean correction of the projected pair velocity
    (momentum_energy_kern.hpp avRvCorrection:43-63)."""
    def sym_dot(gv):
        return (rx * (gv[0] * rx + gv[1] * ry + gv[2] * rz)
                + ry * (gv[3] * ry + gv[4] * rz) + rz * (gv[5] * rz))

    d1, d2 = sym_dot(gv_i), sym_dot(gv_j)
    eta_diff = 5.0 * (eta_ab - eta_crit)
    d3 = torch.where(eta_ab < eta_crit, torch.exp(-(eta_diff**2)), 1.0)
    A = torch.where(d2 != 0.0, d1 / d2, 0.0)
    Ap1 = 1.0 + A
    phi = 0.5 * d3 * torch.clamp(4.0 * A / (Ap1 * Ap1), 0.0, 1.0)
    return -phi * (d1 + d2)


@named_phase("momentum-energy")
def compute_momentum_energy_ve(x, y, z, vx, vy, vz, h, m, prho, c, kx, xm, alpha,
                               c11, c12, c13, c22, c23, c33,
                               nidx, nmask, nc, box: Box, const: SimConstants,
                               block: int = 1024, gradv=None):
    """VE momentum and energy (momentum_energy_kern.hpp:65-222): the
    Atwood-ramped crossed and uncrossed volume elements, per-particle
    alpha viscosity, signal velocity 0.5 (c_i + c_j) - 2 w_ij; with
    ``gradv`` (the six dV arrays) the av_clean correction, eta_crit from
    ``nc`` as the engine computes it (``pair_engine.eta_crit``). Returns
    (ax, ay, az, du, min_dt_courant)."""
    av_clean = gradv is not None

    def body(idx):
        g = pair_geometry(idx, x, y, z, h, nidx, nmask, box)
        h_i = h[idx][:, None]
        h_j = h[g.nj]
        g = sym_mask(g, h_j, const)
        w_i = kernel_w(g.v1 * g.v1, const) / (h_i * h_i * h_i)
        v2 = g.dist / h_j
        w_j = kernel_w(v2 * v2, const) / (h_j * h_j * h_j)

        vx_ij = vx[idx][:, None] - vx[g.nj]
        vy_ij = vy[idx][:, None] - vy[g.nj]
        vz_ij = vz[idx][:, None] - vz[g.nj]
        rv = g.rx * vx_ij + g.ry * vy_ij + g.rz * vz_ij
        if av_clean:
            rv = rv + av_rv_correction(
                g.rx, g.ry, g.rz, torch.minimum(g.v1, v2), pe.eta_crit(nc[idx])[:, None],
                tuple(a[idx][:, None] for a in gradv), tuple(a[g.nj] for a in gradv))
        w_ij = rv / g.dist
        c_i = c[idx][:, None]
        c_j = c[g.nj]
        visc = artificial_viscosity(alpha[idx][:, None], alpha[g.nj], c_i, c_j, w_ij)
        maxvsignal = mmax(g.mask, 0.5 * (c_i + c_j) - 2.0 * w_ij)

        ci = [a[idx][:, None] for a in (c11, c12, c13, c22, c23, c33)]
        tA1_i, tA2_i, tA3_i = iad_project(*ci, g.rx, g.ry, g.rz, w_i)
        cj = [a[g.nj] for a in (c11, c12, c13, c22, c23, c33)]
        tA1_j, tA2_j, tA3_j = iad_project(*cj, g.rx, g.ry, g.rz, w_j)

        m_i = m[idx][:, None]
        m_j = m[g.nj]
        xm_i = xm[idx][:, None]
        xm_j = xm[g.nj]
        rho_i = kx[idx][:, None] * m_i / xm_i
        rho_j = kx[g.nj] * m_j / xm_j
        # the Atwood ramp between uncrossed (xm_i^2, xm_j^2) and crossed
        # (xm_i xm_j) volume elements
        atwood = torch.abs(rho_i - rho_j) / (rho_i + rho_j)
        sigma = const.ramp * (atwood - const.at_min)
        crossed = xm_i * xm_j
        a_ramp = xm_i ** (2.0 - sigma) * xm_j**sigma
        b_ramp = xm_j ** (2.0 - sigma) * xm_i**sigma
        a_mom = torch.where(atwood < const.at_min, xm_i * xm_i,
                            torch.where(atwood > const.at_max, crossed, a_ramp))
        b_mom = torch.where(atwood < const.at_min, xm_j * xm_j,
                            torch.where(atwood > const.at_max, crossed, b_ramp))

        a_visc = m_j / rho_i * visc
        b_visc = m_j / rho_j * visc
        a_visc_x = 0.5 * (a_visc * tA1_i + b_visc * tA1_j)
        a_visc_y = 0.5 * (a_visc * tA2_i + b_visc * tA2_j)
        a_visc_z = 0.5 * (a_visc * tA3_i + b_visc * tA3_j)
        a_visc_energy = msum(g.mask, a_visc_x * vx_ij + a_visc_y * vy_ij + a_visc_z * vz_ij)

        prho_i = prho[idx][:, None]
        energy = msum(g.mask, m_j * a_mom * (vx_ij * tA1_i + vy_ij * tA2_i + vz_ij * tA3_i))
        mom_i = m_j * prho_i * a_mom
        mom_j = m_j * prho[g.nj] * b_mom
        mom_x = msum(g.mask, mom_i * tA1_i + mom_j * tA1_j + a_visc_x)
        mom_y = msum(g.mask, mom_i * tA2_i + mom_j * tA2_j + a_visc_y)
        mom_z = msum(g.mask, mom_i * tA3_i + mom_j * tA3_j + a_visc_z)

        du = const.K * (prho[idx] * energy + 0.5 * torch.clamp_min(a_visc_energy, 0.0))
        dt_i = ts_k_courant(maxvsignal, h[idx], c[idx], const.k_cour)
        return (-const.K * mom_x, -const.K * mom_y, -const.K * mom_z, du, dt_i)

    ax, ay, az, du, dt = blocked_map(body, nidx.shape[0], op_block(block, nidx, "momentum"),
                                     x.device)
    return ax, ay, az, du, torch.min(dt)
