"""What the std and VE steps share: pair sums over chunks of the pair
list, the IAD tensor's inverse, the signal-velocity viscosity, the
Courant and acceleration time steps, the Press and Adams-Bashforth
integrator (SPH-EXA positions.hpp) and the smoothing-length update.

A step's state is a dict of 1-D tensors (x y z x_m1 y_m1 z_m1 vx vy vz h
m temp temp_lo du du_m1 alpha) and 0-d tensors (ttot min_dt min_dt_m1),
all in the working dtype: float64 for the reference, a lower precision
for the control. ``x_m1`` is the last step's displacement."""

from typing import Callable, Dict, Sequence

import torch

from benchmark.reference import kernel as kern
from benchmark.reference.neighbors import find_pairs, min_image

#: pairs one chunk of a pair sum holds
PAIR_CHUNK = 1 << 23
R_GAS = 8.317e7  # sph/eos.hpp


class Geometry:
    """The pair list (i, j) with |r_ij| < 2 h_i, and the box it lives in."""

    def __init__(self, st: Dict[str, torch.Tensor], lo, length, periodic: Sequence[bool]):
        self.n = st["x"].shape[0]
        self.pos = torch.stack([st["x"], st["y"], st["z"]], dim=1)
        self.length = torch.as_tensor([float(v) for v in length], dtype=self.pos.dtype,
                                      device=self.pos.device)
        self.periodic = tuple(bool(p) for p in periodic)
        self.i, self.j = find_pairs(self.pos, 2.0 * st["h"], self.pos, lo, length,
                                    self.periodic, exclude_self=True)
        self.nc = torch.bincount(self.i, minlength=self.n)

    def chunks(self):
        p = self.i.shape[0]
        for a in range(0, p, PAIR_CHUNK):
            yield slice(a, min(a + PAIR_CHUNK, p))

    def sep(self, sl: slice):
        """(i, j, r = x_i - x_j minimum image (P, 3), d) of one chunk."""
        i, j = self.i[sl], self.j[sl]
        r = min_image(self.pos[i] - self.pos[j], self.length, self.periodic)
        return i, j, r, torch.sqrt((r * r).sum(-1))

    def sums(self, fn: Callable, k: int, dtype) -> list:
        """``k`` per-particle sums of the per-pair terms ``fn(i, j, r, d)``
        returns (a tuple of k (P,) tensors, or of None to skip)."""
        acc = [torch.zeros(self.n, dtype=dtype, device=self.pos.device) for _ in range(k)]
        for sl in self.chunks():
            i, j, r, d = self.sep(sl)
            for a, t in zip(acc, fn(i, j, r, d)):
                a.index_add_(0, i, t.to(dtype))
        return acc

    def max(self, fn: Callable, init: float, dtype) -> torch.Tensor:
        """The per-particle max of ``fn(i, j, r, d)`` over its pairs, ``init``
        where it has none (and as the identity)."""
        acc = torch.full((self.n,), init, dtype=dtype, device=self.pos.device)
        for sl in self.chunks():
            i, j, r, d = self.sep(sl)
            acc.scatter_reduce_(0, i, fn(i, j, r, d).to(dtype), "amax", include_self=True)
        return acc


def constants(cfg: dict) -> dict:
    """The step's constants from the configuration file."""
    s, c = cfg["settings"], cfg["constants"]
    out = dict(c)
    out.update(gamma=s["gamma"], ng0=s["ng0"], g=s["gravConstant"],
               cv=R_GAS / s["mui"] / (s["gamma"] - 1.0),
               sinc_index=cfg["kernel"]["sinc_index"],
               K=kern.kernel_norm(cfg["kernel"]["sinc_index"]))
    if cfg["kernel"]["choice"] != "sinc":
        raise ValueError(f"the reference knows the sinc kernel only, not {cfg['kernel']}")
    return out


def w_of(d, h, c):
    """W(d / h)."""
    return kern.sinc_w(d / h, c["sinc_index"])


def iad_inverse(h, t, K: float):
    """The IAD moment matrix tau (the six sums of vol_j W r_a r_b) inverted
    and scaled by h^3 / K: (c11, c12, c13, c22, c23, c33)."""
    # SPH-EXA's exponent renormalisation (ilogb / ldexp): the six sums
    # scaled by a power of two near their mean magnitude, which cancels
    # exactly in adj / det and keeps det inside the dtype's range
    def exp_of(v):
        return torch.where(v != 0.0, torch.frexp(v.float()).exponent, 0)

    esum = sum(exp_of(v) for v in t)
    norm = torch.exp2(-torch.div(esum, 6, rounding_mode="floor").to(h.dtype))
    t11, t12, t13, t22, t23, t33 = (v * norm for v in t)
    det = (t11 * t22 * t33 + 2.0 * t12 * t23 * t13
           - t11 * t23 * t23 - t22 * t13 * t13 - t33 * t12 * t12)
    f = norm * h * h * h / (det * K)
    return ((t22 * t33 - t23 * t23) * f, (t13 * t23 - t33 * t12) * f,
            (t12 * t23 - t22 * t13) * f, (t11 * t33 - t13 * t13) * f,
            (t13 * t12 - t11 * t23) * f, (t11 * t22 - t12 * t12) * f)


def iad_project(cs, r, w, sign: float):
    """sign * (C r) * w for the six components ``cs`` gathered per pair."""
    c11, c12, c13, c22, c23, c33 = cs
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]
    return (sign * (c11 * rx + c12 * ry + c13 * rz) * w,
            sign * (c12 * rx + c22 * ry + c23 * rz) * w,
            sign * (c13 * rx + c23 * ry + c33 * rz) * w)


def viscosity(alpha_i, alpha_j, c_i, c_j, w_ij, beta: float = 2.0):
    """Monaghan's signal-velocity viscosity; approaching pairs only."""
    v_signal = 0.25 * (alpha_i + alpha_j) * (c_i + c_j) - beta * w_ij
    return torch.where(w_ij < 0.0, -v_signal * w_ij, 0.0)


def courant(maxvsignal, h, c, k_cour):
    return k_cour * h / torch.where(maxvsignal > 0.0, maxvsignal, c)



def integrate(st, ax, ay, az, du, dt, c, lo, length, periodic) -> Dict[str, torch.Tensor]:
    """Press's position update and the 2nd-order Adams-Bashforth energy
    step (positions.hpp); the temperature in one sum (the port carries a
    two-sum remainder in temp_lo, which is added here). Open boxes only
    grow and fixed walls are absent in the cells, so nothing is frozen."""
    dt_m1 = st["min_dt"]
    delta_a = dt + 0.5 * dt_m1
    delta_b = 0.5 * (dt + dt_m1)
    out = {}
    for ax_, a, v, dm in (("x", ax, "vx", "x_m1"), ("y", ay, "vy", "y_m1"),
                          ("z", az, "vz", "z_m1")):
        val = st[dm] / dt_m1
        out[v] = val + a * delta_a
        out[dm] = dt * val + a * delta_b * dt
        pos = st[ax_] + out[dm]
        d = "xyz".index(ax_)
        if periodic[d]:
            pos = float(lo[d]) + torch.remainder(pos - float(lo[d]), float(length[d]))
        out[ax_] = pos
    ea = 0.5 * dt * dt / dt_m1
    eb = dt + ea
    u_old = st["temp"] + st["temp_lo"]
    s = u_old + (du * eb - st["du_m1"] * ea) / c["cv"]
    out["temp"] = torch.where(s < 0.0, u_old * torch.exp(s * dt / torch.clamp_min(u_old, 1e-30)),
                              s)
    out["du"] = du
    out["du_m1"] = du
    out["min_dt"] = dt
    out["min_dt_m1"] = st["min_dt"]
    out["ttot"] = st["ttot"] + dt
    return out


def update_h(ng0: int, nc1, h):
    """Nudge h so that the count with self (``nc1``) drifts to ng0."""
    return h * 0.5 * (1.0 + 1023.0 * ng0 / torch.clamp_min(nc1.to(h.dtype), 1.0)) ** 0.1


def count_from_h(h_new, h_old, ng0: int):
    """The neighbour count without self that ``update_h`` was given,
    recovered from its output (float64): nc + 1 = 1023 ng0 / ((2 h'/h)^10 - 1)."""
    q = (2.0 * h_new.double() / h_old.double()) ** 10 - 1.0
    return torch.round(1023.0 * ng0 / q).long() - 1


def conserved(st, m, cv: float, egrav: float) -> Dict[str, float]:
    """Energies and momentum norms of a state (the ledger's quantities,
    observables/conserved.hpp), the products and sums in the state's
    dtype."""
    f = {k: st[k] for k in ("x", "y", "z", "vx", "vy", "vz", "temp")}
    m = m.to(f["x"].dtype)
    v2 = f["vx"] ** 2 + f["vy"] ** 2 + f["vz"] ** 2
    ecin = 0.5 * float(torch.sum(m * v2))
    eint = float(torch.sum(cv * f["temp"] * m))
    mv = torch.stack([m * f["vx"], m * f["vy"], m * f["vz"]])
    r = torch.stack([f["x"], f["y"], f["z"]])
    lin = mv.sum(1)
    ang = torch.linalg.cross(r, mv, dim=0).sum(1)
    return {"ecin": ecin, "eint": eint, "egrav": egrav, "etot": ecin + eint + egrav,
            "linmom": float(torch.linalg.vector_norm(lin)),
            "angmom": float(torch.linalg.vector_norm(ang)),
            "mv_abs": float(torch.sum(m * torch.sqrt(v2))),
            "rmv_abs": float(torch.sum(m * torch.sqrt(v2) * torch.sqrt((r * r).sum(0))))}

