"""One standard-SPH step (SPH-EXA std_hydro.hpp, HydroProp::step): every
pair within 2 h_i, density, the ideal-gas EOS, the IAD tensor,
momentum and energy with the constant-alpha viscosity and the min-h
symmetric cutoff, the time step, the integrator and the smoothing-length
update. Self-gravity, where the configuration has it, is added by the
caller's ``gravity`` function."""

import torch

from benchmark.reference import common as cm


def forces(st, geo: cm.Geometry, c: dict):
    """Density -> EOS -> IAD -> momentum and energy. Returns a dict of
    rho, c, the accelerations, du and the Courant dt."""
    dt_ = st["x"].dtype
    h, m, K = st["h"], st["m"], c["K"]
    (s_rho,) = geo.sums(lambda i, j, r, d: (m[j] * cm.w_of(d, h[i], c),), 1, dt_)
    rho = K * (m + s_rho) / (h * h * h)
    tmp = c["cv"] * st["temp"] * (c["gamma"] - 1.0)
    p, cs = rho * tmp, torch.sqrt(tmp)
    vol = m / rho

    def iad_terms(i, j, r, d):
        vw = vol[j] * cm.w_of(d, h[i], c)
        return (r[:, 0] * r[:, 0] * vw, r[:, 0] * r[:, 1] * vw, r[:, 0] * r[:, 2] * vw,
                r[:, 1] * r[:, 1] * vw, r[:, 1] * r[:, 2] * vw, r[:, 2] * r[:, 2] * vw)

    C = cm.iad_inverse(h, geo.sums(iad_terms, 6, dt_), K)
    v = torch.stack([st["vx"], st["vy"], st["vz"]], dim=1)

    def pair(i, j, r, d):
        # the min-h symmetric cutoff: d < 2 h_j as well
        sym = d < 2.0 * h[j]
        d_safe = torch.where(d > 0, d, 1.0)
        w_i = cm.w_of(d, h[i], c) / h[i] ** 3
        w_j = cm.w_of(d, h[j], c) / h[j] ** 3
        vij = v[i] - v[j]
        w_ij = (r * vij).sum(-1) / d_safe
        visc = 0.5 * cm.viscosity(1.0, 1.0, cs[i], cs[j], w_ij)
        tA_i = cm.iad_project([a[i] for a in C], r, 1.0, 1.0)
        tA_j = cm.iad_project([a[j] for a in C], r, 1.0, 1.0)
        mj_pro_i = m[j] * p[i] / (rho[i] * rho[i])
        mi_roi = m[i] / rho[i]
        mj_roj_wj = m[j] / rho[j] * w_j
        a = w_i * (mj_pro_i + visc * mi_roi)
        b = mj_roj_wj * (p[j] / rho[j] + visc)
        a_e = w_i * (2.0 * mj_pro_i + visc * mi_roi)
        b_e = visc * mj_roj_wj
        energy = (vij[:, 0] * (a_e * tA_i[0] + b_e * tA_j[0])
                  + vij[:, 1] * (a_e * tA_i[1] + b_e * tA_j[1])
                  + vij[:, 2] * (a_e * tA_i[2] + b_e * tA_j[2]))
        z = torch.zeros_like(d)
        return tuple(torch.where(sym, t, z) for t in (
            a * tA_i[0] + b * tA_j[0], a * tA_i[1] + b * tA_j[1], a * tA_i[2] + b * tA_j[2],
            energy))

    mx, my, mz, en = geo.sums(pair, 4, dt_)

    def vsig(i, j, r, d):
        vij = v[i] - v[j]
        w_ij = (r * vij).sum(-1) / torch.where(d > 0, d, 1.0)
        return torch.where(d < 2.0 * h[j], cs[i] + cs[j] - 3.0 * w_ij, 0.0)

    maxv = geo.max(vsig, 0.0, dt_)
    dt_c = torch.min(cm.courant(maxv, h, cs, c["k_cour"]))
    return {"rho": rho, "c": cs, "ax": K * mx, "ay": K * my, "az": K * mz,
            "du": -K * 0.5 * en, "dt_courant": dt_c}


def step(st, geo: cm.Geometry, c: dict, box: dict, gravity=None):
    """One step from state ``st`` (dict of tensors). ``gravity(ax, ay, az)``
    returns (ax, ay, az, egrav, dt_acc) with the self-gravity added.
    Returns (new state, the force stage's fields)."""
    f = forces(st, geo, c)
    ax, ay, az = f["ax"], f["ay"], f["az"]
    dts = [f["dt_courant"], c["max_dt_increase"] * st["min_dt"]]
    egrav = 0.0
    if gravity is not None:
        ax, ay, az, egrav, dt_acc = gravity(ax, ay, az)
        dts.append(dt_acc)
    dt = torch.min(torch.stack([torch.as_tensor(x, dtype=st["x"].dtype) for x in dts]))
    new = cm.integrate(st, ax, ay, az, f["du"], dt, c, box["lo"], box["length"],
                       box["periodic"])
    new["h"] = cm.update_h(c["ng0"], geo.nc + 1, st["h"])
    new["alpha"] = st["alpha"]
    f.update(ax=ax, ay=ay, az=az, dt=dt, egrav=egrav, nc=geo.nc)
    return new, f
