"""Self-gravity by direct summation with SPH-EXA's softening (the P2P
law of ryoanji's kernel.hpp: inside h_i + h_j the distance is clamped to
it), on a set of target rows against every particle, and the total
potential energy from an exact spherical part plus a sampled remainder.

A direct sum over all 10^6 x 10^6 pairs costs more than a run's window,
so the energy is 0.5 sum m_i phi_i = 0.5 sum m_i Phi_s(r_i) + 0.5 sum
m_i (phi_i - Phi_s(r_i)), where Phi_s is the potential of the particles
spread into concentric shells about the centre of mass (exact in
O(N log N) by the shell theorem) and the second sum, small for a near
spherical body, is estimated from a uniform sample of rows."""

import torch

#: target rows of one block of the direct sum
ROWS_PER_BLOCK = 32


def direct(tpos, th, pos, m, h, G: float):
    """Accelerations (T, 3) and potentials (T,) of targets at ``tpos`` with
    smoothing lengths ``th`` from every particle (a target that is itself
    a particle gets nothing from itself: its separation is 0)."""
    acc, phi = [], []
    for a in range(0, tpos.shape[0], ROWS_PER_BLOCK):
        t = tpos[a:a + ROWS_PER_BLOCK]
        d = pos[None, :, :] - t[:, None, :]
        r2 = (d * d).sum(-1)
        hij = th[a:a + ROWS_PER_BLOCK, None] + h[None, :]
        r2e = torch.maximum(r2, hij * hij)
        inv3m = m[None, :] / (r2e * torch.sqrt(r2e))
        acc.append((d * inv3m[:, :, None]).sum(1))
        phi.append(-(inv3m * r2).sum(1))
    return G * torch.cat(acc), G * torch.cat(phi)


def shell_potential(pos, m, G: float):
    """(Phi_s, the magnitude of the shells' acceleration) per particle: the
    particles as concentric shells about the centre of mass."""
    com = (pos * m[:, None]).sum(0) / m.sum()
    r = torch.sqrt(((pos - com) ** 2).sum(-1))
    order = torch.argsort(r)
    rs, ms = r[order], m[order]
    inner = torch.cumsum(ms, 0) - ms
    rs_safe = torch.clamp_min(rs, 1e-12)
    outer = torch.flip(torch.cumsum(torch.flip(ms / rs_safe, [0]), 0), [0]) - ms / rs_safe
    phi_s = torch.empty_like(r)
    phi_s[order] = -G * (inner / rs_safe + outer)
    g_s = torch.empty_like(r)
    g_s[order] = G * inner / (rs_safe * rs_safe)
    return phi_s, g_s


def make_gravity(st, c: dict, sample, top: int, rows=None):
    """The step's gravity function: direct sums on the rows of ``sample``
    (a 1-D index tensor) and on the ``top`` rows whose hydro plus
    spherical acceleration is largest (the candidates for the
    acceleration time step), or on ``rows`` where given (the control uses
    the reference's). Rows outside get NaN accelerations: the comparison
    reads them only where it has them."""
    G = float(c["g"])
    pos = torch.stack([st["x"], st["y"], st["z"]], dim=1)
    m, h = st["m"], st["h"]
    out = {}
    given = rows

    def gravity(ax, ay, az):
        phi_s, g_s = shell_potential(pos, m, G)
        a_h = torch.sqrt(ax * ax + ay * ay + az * az)
        if given is None:
            k = min(top, pos.shape[0])
            cand = torch.topk((a_h + g_s).double(), k).indices
            rows = torch.unique(torch.cat([sample, cand]))
        else:
            rows = given
        ag, phi = direct(pos[rows], h[rows], pos, m, h, G)
        nan = torch.full_like(ax, float("nan"))
        gx, gy, gz = nan.clone(), nan.clone(), nan.clone()
        gx[rows], gy[rows], gz[rows] = ag[:, 0], ag[:, 1], ag[:, 2]
        tx, ty, tz = ax + gx, ay + gy, az + gz
        a_max = torch.sqrt(torch.max(tx[rows] ** 2 + ty[rows] ** 2 + tz[rows] ** 2))
        dt_acc = c["eta_acc"] * torch.sqrt(c["eps"] / a_max)
        # the energy: the shells exactly, the remainder from the sample
        ins = torch.isin(rows, sample)
        rem = 0.5 * m[rows][ins] * (phi[ins] - phi_s[rows][ins])
        n = pos.shape[0]
        base = 0.5 * torch.sum(m * phi_s)
        if sample.numel() == n:
            egrav = base + rem.sum()
            stderr = 0.0
        else:
            egrav = base + n * rem.mean()
            stderr = float(n * rem.std() / rem.numel() ** 0.5)
        out.update(rows=rows, gx=gx, gy=gy, gz=gz, egrav_stderr=stderr)
        return tx, ty, tz, float(egrav), dt_acc

    return gravity, out
