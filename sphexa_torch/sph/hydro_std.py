"""Standard-SPH EOS and the gather backend's std ops
(sphexa_tpu/sph/hydro_std.py): density, IAD and momentum/energy as masked
j-reductions over the (N, ngmax) lists of
``neighbors.cell_list.find_neighbors``, each mapped over row blocks
(util/blocking.py) so that the gathered tiles stay bounded. The pair
engine's ops (sph/pair_engine.py) sum every pair within 2h instead; these
keep the lists' first ``ngmax`` neighbours, as the reference's
findneighbors.hpp does. The targets are the list's rows; the fields an op
reads on the j side may be j-buffers [own slab | halo rows] (sph/pairs.py)."""

import torch

from sphexa_torch.sfc.box import Box
from sphexa_torch.sph.kernels import artificial_viscosity, sinc_kernel_u, ts_k_courant
from sphexa_torch.sph.pairs import iad_project, mmax, msum, pair_geometry
from sphexa_torch.sph.particles import SimConstants
from sphexa_torch.util.blocking import blocked_map, device_block
from sphexa_torch.util.phases import named_phase

#: float32 (B, ngmax) temporaries each op's block body holds at its peak
#: (sizes its blocks on the card)
TILE_FIELDS = {"density": 8, "iad": 16, "momentum": 48}


def op_block(block: int, nidx, op: str) -> int:
    """Rows of an op's block on ``nidx``'s device (``device_block``)."""
    return device_block(block, nidx.shape[1] * 4 * TILE_FIELDS[op], nidx.device)


def compute_eos_std(temp: torch.Tensor, rho: torch.Tensor, const: SimConstants):
    """Ideal-gas EOS from temperature (eos.hpp idealGasEOS): returns (p, c)."""
    tmp = const.cv * temp * (const.gamma - 1.0)
    return rho * tmp, torch.sqrt(tmp)


def kernel_w(u, const: SimConstants):
    """W of the run's kernel from u = (d / h)^2."""
    return sinc_kernel_u(u, const.sinc_index, const.kernel_choice)


@named_phase("density")
def compute_density(x, y, z, h, m, nidx, nmask, box: Box, const: SimConstants,
                    block: int = 2048):
    """rho_i = K h_i^-3 (m_i + sum_j m_j W(|r_ij| / h_i)) over the lists."""
    def body(idx):
        g = pair_geometry(idx, x, y, z, h, nidx, nmask, box)
        rho0 = m[idx] + msum(g.mask, m[g.nj] * kernel_w(g.v1 * g.v1, const))
        h_i = h[idx]
        return const.K * rho0 / (h_i * h_i * h_i)

    return blocked_map(body, nidx.shape[0], op_block(block, nidx, "density"), x.device)


def iad_invert(h_i, t11, t12, t13, t22, t23, t33, K: float):
    """The IAD moment matrix's inverse scaled by h^3 / K, after the
    exponent renormalization (the reference's ilogb/ldexp trick, with
    frexp): the power-of-two factor cancels exactly in adj / det."""
    def exp_of(v):
        return torch.where(v != 0.0, torch.frexp(v).exponent, 0)

    esum = (exp_of(t11) + exp_of(t12) + exp_of(t13)
            + exp_of(t22) + exp_of(t23) + exp_of(t33))
    norm = torch.exp2(-torch.div(esum, 6, rounding_mode="floor").to(t11.dtype))
    t11, t12, t13 = t11 * norm, t12 * norm, t13 * norm
    t22, t23, t33 = t22 * norm, t23 * norm, t33 * norm
    det = (t11 * t22 * t33 + 2.0 * t12 * t23 * t13
           - t11 * t23 * t23 - t22 * t13 * t13 - t33 * t12 * t12)
    factor = norm * (h_i * h_i * h_i) / (det * K)
    return ((t22 * t33 - t23 * t23) * factor, (t13 * t23 - t33 * t12) * factor,
            (t12 * t23 - t22 * t13) * factor, (t11 * t33 - t13 * t13) * factor,
            (t13 * t12 - t11 * t23) * factor, (t11 * t22 - t12 * t12) * factor)


@named_phase("iad")
def compute_iad(x, y, z, h, vol_j, nidx, nmask, box: Box, const: SimConstants,
                block: int = 2048):
    """The integral-approach-to-derivatives tensor: tau = sum_j vol_j W r
    (x) r and its inverse's six components scaled by h^3 / K. ``vol_j``:
    m / rho (std) or xm / kx (VE)."""
    def body(idx):
        g = pair_geometry(idx, x, y, z, h, nidx, nmask, box)
        vw = torch.where(g.mask, vol_j[g.nj] * kernel_w(g.v1 * g.v1, const), 0.0)
        return iad_invert(h[idx], torch.sum(g.rx * g.rx * vw, -1),
                          torch.sum(g.rx * g.ry * vw, -1), torch.sum(g.rx * g.rz * vw, -1),
                          torch.sum(g.ry * g.ry * vw, -1), torch.sum(g.ry * g.rz * vw, -1),
                          torch.sum(g.rz * g.rz * vw, -1), const.K)

    return blocked_map(body, nidx.shape[0], op_block(block, nidx, "iad"), x.device)


def sym_mask(g, h_j, const: SimConstants):
    """The min-h symmetric cutoff (``const.sym_pairs``): a pair also needs
    dist < 2 h_j, which makes the pair forces exactly antisymmetric."""
    if getattr(const, "sym_pairs", True):
        return g._replace(mask=g.mask & (g.dist < 2.0 * h_j))
    return g


@named_phase("momentum-energy")
def compute_momentum_energy_std(x, y, z, vx, vy, vz, h, m, rho, p, c,
                                c11, c12, c13, c22, c23, c33,
                                nidx, nmask, box: Box, const: SimConstants, block: int = 1024):
    """Pressure-gradient accelerations, energy rate and Courant dt
    (momentum_energy_kern.hpp:12-134): symmetrized IAD gradient terms,
    constant-alpha viscosity halved per pair, signal velocity
    c_i + c_j - 3 w_ij. Returns (ax, ay, az, du, min_dt_courant)."""
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
        w_ij = (g.rx * vx_ij + g.ry * vy_ij + g.rz * vz_ij) / g.dist

        c_i = c[idx][:, None]
        c_j = c[g.nj]
        visc = 0.5 * artificial_viscosity(1.0, 1.0, c_i, c_j, w_ij)
        maxvsignal = mmax(g.mask, c_i + c_j - 3.0 * w_ij)

        ci = [a[idx][:, None] for a in (c11, c12, c13, c22, c23, c33)]
        tA1_i, tA2_i, tA3_i = iad_project(*ci, g.rx, g.ry, g.rz, sign=1.0)
        cj = [a[g.nj] for a in (c11, c12, c13, c22, c23, c33)]
        tA1_j, tA2_j, tA3_j = iad_project(*cj, g.rx, g.ry, g.rz, sign=1.0)

        rho_i = rho[idx][:, None]
        rho_j = rho[g.nj]
        m_j = m[g.nj]
        mi_roi = (m[idx] / rho[idx])[:, None]
        mj_pro_i = m_j * p[idx][:, None] / (rho_i * rho_i)
        mj_roj_wj = m_j / rho_j * w_j

        a = w_i * (mj_pro_i + visc * mi_roi)
        b = mj_roj_wj * (p[g.nj] / rho_j + visc)
        mom_x = msum(g.mask, a * tA1_i + b * tA1_j)
        mom_y = msum(g.mask, a * tA2_i + b * tA2_j)
        mom_z = msum(g.mask, a * tA3_i + b * tA3_j)

        a_e = w_i * (2.0 * mj_pro_i + visc * mi_roi)
        b_e = visc * mj_roj_wj
        energy = msum(g.mask, vx_ij * (a_e * tA1_i + b_e * tA1_j)
                      + vy_ij * (a_e * tA2_i + b_e * tA2_j)
                      + vz_ij * (a_e * tA3_i + b_e * tA3_j))
        dt_i = ts_k_courant(maxvsignal, h[idx], c[idx], const.k_cour)
        return (const.K * mom_x, const.K * mom_y, const.K * mom_z,
                -const.K * 0.5 * energy, dt_i)

    ax, ay, az, du, dt = blocked_map(body, nidx.shape[0], op_block(block, nidx, "momentum"),
                                     x.device)
    return ax, ay, az, du, torch.min(dt)
