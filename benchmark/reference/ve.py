"""One generalised-volume-element SPH step (SPH-EXA ve_hydro.hpp,
HydroVeProp::step): xmass, the VE normalisation and grad-h term, the VE
EOS, the IAD tensor over xm / kx, divv and curlv, the viscosity
switches, momentum and energy with the Atwood-ramped volume elements and
per-particle alpha, self-gravity from the caller, the time step, the
integrator and the smoothing-length update."""

import torch

from benchmark.reference import common as cm
from benchmark.reference import kernel as kern


def forces(st, geo: cm.Geometry, c: dict):
    dt_ = st["x"].dtype
    h, m, K, n_s = st["h"], st["m"], c["K"], c["sinc_index"]
    h3 = h * h * h
    (s0,) = geo.sums(lambda i, j, r, d: (m[j] * cm.w_of(d, h[i], c),), 1, dt_)
    xm = m / (K * (m + s0) / h3)

    def gradh_terms(i, j, r, d):
        dterh = kern.sinc_dterh(d / h[i], n_s)
        return xm[j] * cm.w_of(d, h[i], c), xm[j] * dterh, m[j] * dterh

    s_kx, s_wh, s_wr = geo.sums(gradh_terms, 3, dt_)
    kx = K * (xm + s_kx) / h3
    whomega = K * (-3.0 * xm + s_wh) / h3 / h
    wrho0 = K * (-3.0 * m + s_wr) / h3 / h
    whomega = whomega * m / xm + (kx - K * xm / h3) * wrho0
    rho = kx * m / xm
    gradh = 1.0 - (-h / (rho * 3.0)) * whomega
    tmp = c["cv"] * st["temp"] * (c["gamma"] - 1.0)
    p, cs = rho * tmp, torch.sqrt(tmp)
    prho = p / (kx * m * m * gradh)
    vol = xm / kx

    def iad_terms(i, j, r, d):
        vw = vol[j] * cm.w_of(d, h[i], c)
        return (r[:, 0] * r[:, 0] * vw, r[:, 0] * r[:, 1] * vw, r[:, 0] * r[:, 2] * vw,
                r[:, 1] * r[:, 1] * vw, r[:, 1] * r[:, 2] * vw, r[:, 2] * r[:, 2] * vw)

    C = cm.iad_inverse(h, geo.sums(iad_terms, 6, dt_), K)
    v = torch.stack([st["vx"], st["vy"], st["vz"]], dim=1)

    def divv_terms(i, j, r, d):
        tA = cm.iad_project([a[i] for a in C], r, cm.w_of(d, h[i], c), -1.0)
        dv = (v[j] - v[i]) * xm[j][:, None]
        return tuple(dv[:, a] * tA[b] for a in range(3) for b in range(3))

    g = geo.sums(divv_terms, 9, dt_)
    norm = K / h3 / kx
    divv = norm * (g[0] + g[4] + g[8])
    curl = (g[7] - g[5], g[2] - g[6], g[3] - g[1])
    curlv = norm * torch.sqrt(curl[0] ** 2 + curl[1] ** 2 + curl[2] ** 2)
    dt_rho = c["k_rho"] / torch.abs(torch.max(divv))

    # the viscosity switches, with the previous step's dt
    def vsig_sw(i, j, r, d):
        rv = (r * (v[i] - v[j])).sum(-1)
        return torch.where(rv < 0.0, cs[i] + cs[j] - 3.0 * rv / d, 0.0)

    vij_sig = torch.maximum(geo.max(vsig_sw, 0.0, dt_), 1e-40 * cs)

    def graddivv_terms(i, j, r, d):
        w = K / h3[i] * cm.w_of(d, h[i], c)
        tA = cm.iad_project([a[i] for a in C], r, w, -1.0)
        fac = xm[j] / kx[j] * (divv[i] - divv[j])
        return fac * tA[0], fac * tA[1], fac * tA[2]

    gdx, gdy, gdz = geo.sums(graddivv_terms, 3, dt_)
    a_const = h * h * torch.sqrt(gdx * gdx + gdy * gdy + gdz * gdz)
    alphaloc = torch.where(divv < 0.0, c["alphamax"] * a_const
                           / (a_const + h * torch.abs(divv) + 0.05 * cs), 0.0)
    alpha0 = st["alpha"]
    decay = h / (c["decay_constant"] * vij_sig)
    target = torch.where(alphaloc >= c["alphamin"], alphaloc, c["alphamin"])
    alpha = torch.where(alphaloc >= alpha0, alphaloc,
                        alpha0 + (target - alpha0) / decay * st["min_dt"])

    ramp = 1.0 / (c["at_max"] - c["at_min"])

    def pair(i, j, r, d):
        sym = d < 2.0 * h[j]
        w_i = cm.w_of(d, h[i], c) / h3[i]
        w_j = cm.w_of(d, h[j], c) / h3[j]
        vij = v[i] - v[j]
        w_ij = (r * vij).sum(-1) / d
        visc = cm.viscosity(alpha[i], alpha[j], cs[i], cs[j], w_ij)
        tA_i = cm.iad_project([a[i] for a in C], r, w_i, -1.0)
        tA_j = cm.iad_project([a[j] for a in C], r, w_j, -1.0)
        xi, xj = xm[i], xm[j]
        rho_i, rho_j = rho[i], rho[j]
        atwood = torch.abs(rho_i - rho_j) / (rho_i + rho_j)
        sigma = ramp * (atwood - c["at_min"])
        crossed = xi * xj
        a_mom = torch.where(atwood < c["at_min"], xi * xi,
                            torch.where(atwood > c["at_max"], crossed,
                                        xi ** (2.0 - sigma) * xj**sigma))
        b_mom = torch.where(atwood < c["at_min"], xj * xj,
                            torch.where(atwood > c["at_max"], crossed,
                                        xj ** (2.0 - sigma) * xi**sigma))
        a_visc = m[j] / rho_i * visc
        b_visc = m[j] / rho_j * visc
        av = [0.5 * (a_visc * tA_i[k] + b_visc * tA_j[k]) for k in range(3)]
        av_energy = av[0] * vij[:, 0] + av[1] * vij[:, 1] + av[2] * vij[:, 2]
        energy = m[j] * a_mom * (vij[:, 0] * tA_i[0] + vij[:, 1] * tA_i[1] + vij[:, 2] * tA_i[2])
        mom_i = m[j] * prho[i] * a_mom
        mom_j = m[j] * prho[j] * b_mom
        z = torch.zeros_like(d)
        return tuple(torch.where(sym, t, z) for t in (
            mom_i * tA_i[0] + mom_j * tA_j[0] + av[0], mom_i * tA_i[1] + mom_j * tA_j[1] + av[1],
            mom_i * tA_i[2] + mom_j * tA_j[2] + av[2], energy, av_energy))

    mx, my, mz, en, ave = geo.sums(pair, 5, dt_)

    def vsig(i, j, r, d):
        w_ij = (r * (v[i] - v[j])).sum(-1) / d
        return torch.where(d < 2.0 * h[j], 0.5 * (cs[i] + cs[j]) - 2.0 * w_ij, 0.0)

    maxv = geo.max(vsig, 0.0, dt_)
    du = K * (prho * en + 0.5 * torch.clamp_min(ave, 0.0))
    return {"rho": rho, "c": cs, "ax": -K * mx, "ay": -K * my, "az": -K * mz, "du": du,
            "dt_courant": torch.min(cm.courant(maxv, h, cs, c["k_cour"])), "dt_rho": dt_rho,
            "alpha": alpha, "divv": divv, "curlv": curlv, "xm": xm, "kx": kx, "gradh": gradh}


def step(st, geo: cm.Geometry, c: dict, box: dict, gravity=None):
    """One step from state ``st``; ``gravity(ax, ay, az)`` returns (ax, ay,
    az, egrav, dt_acc) with self-gravity added. Returns (new state, the
    force stage's fields)."""
    f = forces(st, geo, c)
    ax, ay, az = f["ax"], f["ay"], f["az"]
    dts = [f["dt_courant"], c["max_dt_increase"] * st["min_dt"], f["dt_rho"]]
    egrav = 0.0
    if gravity is not None:
        ax, ay, az, egrav, dt_acc = gravity(ax, ay, az)
        dts.append(dt_acc)
    dt = torch.min(torch.stack([torch.as_tensor(x, dtype=st["x"].dtype) for x in dts]))
    new = cm.integrate(st, ax, ay, az, f["du"], dt, c, box["lo"], box["length"],
                       box["periodic"])
    new["h"] = cm.update_h(c["ng0"], geo.nc + 1, st["h"])
    new["alpha"] = f["alpha"]
    f.update(ax=ax, ay=ay, az=az, dt=dt, egrav=egrav, nc=geo.nc)
    return new, f
