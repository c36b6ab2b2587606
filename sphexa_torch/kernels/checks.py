"""Kernel-vs-plain checks that chip_smoke.py and tests/test_torch_gpu.py
share: one contract, stated once, with the JAX package's tolerances.

``ve_chain_vs_plain`` runs the VE ops' chain (xmass over the density
kernel, grad-h, EOS, IAD, divv/curlv, AV switches, momentum/energy) on a
sorted state on the card, each op's wrapper against its plain version on
the kernel chain's inputs; with ``lists`` the list-mode forms the JAX
dispatch picks. Any disagreement raises."""

from types import SimpleNamespace

import torch

from sphexa_torch.sph import pair_engine as pe
from sphexa_torch.sph.hydro_ve import compute_eos_ve


def _close(name: str, what: str, a, b, rtol: float, atol: float) -> float:
    torch.testing.assert_close(a, b, rtol=rtol, atol=atol, msg=f"{name}: {what}")
    return float((a - b).abs().max())


def ve_chain_vs_plain(name: str, ss, box, const, nbr, av_clean: bool, keys=None,
                      ranges=None, lists=None):
    """Each VE op's wrapper against its plain version, with the JAX
    package's streaming tolerances (tests/test_pallas_interpret.py): nc
    exact; xm and kx rtol 1e-5; grad-h rtol 5e-4 / atol 1e-5; divv/curlv
    (and gradv) rtol 1e-4 / atol 1e-5 max|divv|; alpha rtol 1e-4 / atol
    1e-6; a and du rtol 2e-4 / atol 1e-5 max|.|; min dt rel 1e-4.

    Returns (results, chain): per-entry-point results keyed as in
    ``pe.LAUNCHES`` ("xmass" for the density kernel's VE use) with each
    max abs error, and the kernel chain's tensors (xm, nc, kx, gradh, prho,
    c, cs, dv, alpha, gradv) for callers that time or count the ops."""
    kw = {"ranges": ranges, "lists": lists}
    walk = lists is not None
    x, y, z, h, m, vel = ss.x, ss.y, ss.z, ss.h, ss.m, (ss.vx, ss.vy, ss.vz)

    res = {}
    xm, nc, _ = pe.pallas_xmass(x, y, z, h, m, keys, box, const, nbr, **kw)
    xm_p, nc_p, _ = pe.xmass_plain(x, y, z, h, m, keys, box, const, nbr, **kw)
    if not torch.equal(nc, nc_p):
        raise AssertionError(f"{name}: xmass nc differs at {int((nc != nc_p).sum())} targets")
    res["xmass"] = {"max_abs_err": _close(name, "xm", xm, xm_p, 1e-5, 0.0),
                    "nb_pairs": int(nc_p.to(torch.int64).sum())}
    (kx, gradh), _ = pe.pallas_ve_def_gradh(x, y, z, h, m, xm, keys, box, const, nbr, **kw)
    (kx_p, gradh_p), _ = pe.ve_def_gradh_plain(x, y, z, h, m, xm, keys, box, const, nbr,
                                               **kw)
    res["ve_def_gradh"] = {"max_abs_err": max(
        _close(name, "kx", kx, kx_p, 1e-5, 0.0),
        _close(name, "gradh", gradh, gradh_p, 5e-4, 1e-5))}
    prho, c, _, _ = compute_eos_ve(ss.temp, m, kx, xm, gradh, const)
    cs, _ = pe.pallas_iad(x, y, z, h, xm / kx, keys, box, const, nbr, **kw)
    dargs = (x, y, z, *vel, h, kx, xm, *cs, keys, box, const, nbr)
    dv, _ = pe.pallas_iad_divv_curlv(*dargs, with_gradv=av_clean, **kw)
    dv_p, _ = pe.iad_divv_curlv_plain(*dargs, with_gradv=av_clean, **kw)
    scale = float(dv_p[0].abs().max())
    dkey = "iad_divv_curlv_lists" if walk and av_clean else "iad_divv_curlv"
    res[dkey] = {"max_abs_err": max(
        _close(name, f"divv/curlv output {k}", a, b, 1e-4, 1e-5 * scale)
        for k, (a, b) in enumerate(zip(dv, dv_p)))}
    aargs = (x, y, z, *vel, h, c, kx, xm, dv[0], ss.alpha, *cs, keys, box, ss.min_dt,
             const, nbr)
    alpha, _ = pe.pallas_av_switches(*aargs, **kw)
    akey = "av_switches_lists" if walk else "av_switches"
    res[akey] = {"max_abs_err": _close(name, "alpha", alpha,
                                       pe.av_switches_plain(*aargs, **kw)[0], 1e-4, 1e-6)}
    margs = (x, y, z, *vel, h, m, prho, c, kx, xm, alpha, *cs, keys, box, const, nbr)
    gradv = tuple(dv[2:]) if av_clean else None
    out = pe.pallas_momentum_energy_ve(*margs, nc=nc, gradv=gradv, **kw)
    out_p = pe.momentum_energy_ve_plain(*margs, nc=nc, gradv=gradv, **kw)
    err = max(_close(name, nm, a, b, 2e-4, 1e-5 * float(b.abs().max()))
              for nm, a, b in zip(("ax", "ay", "az", "du"), out[:4], out_p[:4]))
    dk, dp = float(out[4]), float(out_p[4])
    if abs(dk - dp) > 1e-4 * abs(dp):
        raise AssertionError(f"{name}: VE min dt {dk} vs plain {dp}")
    mkey = "momentum_energy_ve_lists" if walk else "momentum_energy_ve"
    res[mkey] = {"max_abs_err": err, "min_dt_rel_err": abs(dk - dp) / abs(dp)}
    chain = SimpleNamespace(xm=xm, nc=nc, kx=kx, gradh=gradh, prho=prho, c=c, cs=cs,
                            dv=dv, alpha=alpha, gradv=gradv)
    return res, chain
