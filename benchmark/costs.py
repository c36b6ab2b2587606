"""The yardstick of the kernels' roofline: the published peaks of one
NVIDIA H100 SXM and the per-pair operation counts of the SPH force ops,
frozen from sphexa_torch/kernels/costs.py (its BODY_OPS and IO_ARRAYS,
counted from csrc/pair_ops.cuh) so that a later change to the port
cannot move them.

An op's least time on a step is the larger of its operations over the
FP32 peak and its bytes over the HBM bandwidth. Operations are the
interacting pairs the inputs need (|r_ij| < 2 h_i, counted by the
reference; the momentum ops' pairs also have |r_ij| < 2 h_j) times the
op's operations per pair: the separation and its square (8) and the
body. Bytes are each per-particle float32 array read once and each
output written once. Lanes, pruned runs and list masks are the
implementation's work and are not counted."""

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
GEOM_OPS = 8

#: op -> (operations per interacting pair besides GEOM_OPS, float32 arrays
#: read, arrays written, pairs: "all" (|r| < 2 h_i) or "sym")
OPS = {
    "std": {"density": (32, 6, 2, "all"), "iad": (50, 6, 6, "all"),
            "momentum_energy_std": (156 + 2, 21, 5, "sym")},
    "ve": {"xmass": (32, 6, 2, "all"), "ve_def_gradh": (66, 7, 2, "all"),
           "iad": (50, 6, 6, "all"), "iad_divv_curlv": (75, 16, 2, "all"),
           "av_switches": (74, 19, 1, "all"), "momentum_energy_ve": (178 + 2, 24, 5, "sym")},
}


def least_seconds(prop: str, n: int, pairs: float, sym_pairs: float) -> float:
    """The SPH force ops' least time on one step of n particles."""
    total = 0.0
    for body, reads, writes, kind in OPS[prop].values():
        p = pairs if kind == "all" else sym_pairs
        ops = p * (GEOM_OPS + body)
        nbytes = 4.0 * n * (reads + writes)
        total += max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
    return total
