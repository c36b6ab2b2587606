"""The five kernels' cost rules: the operations and bytes of each CUDA
kernel's launch, from the counts of the run that launches it.

These are the bound formulas of PERF.md's kernel table (each input read
once, each output written once; the operations each pair, lane or slot
runs, counted from csrc/pair_ops.cuh and the kernels' sources), which
``chip_smoke.py`` reports beside each kernel's time. The static cost layer
(devtools/audit) charges them too: the CUDA kernels launch through ctypes,
which the tally's dispatch mode never sees (as the JAX cost walk treats a
``pallas_call`` as an opaque leaf), so every dispatch site charges its
kernel's rule (``pair_engine.charge_pair``, ``charge_list_build``,
``charge_p2p``, ``charge_compact``, ``charge_compact_row``), identically on
the CPU, whose plain version runs instead, and on the card.

A dispatch runs inside ``charging()``: while a tally runs, neither
branch's aten ops are charged. On the card those are the wrapper's
``empty`` outputs (free anyway) and K12's block order (a sum and an
argsort of the leaf lengths); on the CPU the whole plain version. Neither
has a counterpart on the other device, so the launch is charged by its
rule alone and both devices tally the same. No wrapper fills its outputs
with zeros; the ops that precombine a kernel's fields run before the
dispatch and are charged as step work. Outside a tally a charge is one
read of ``phases._TALLY``: no sync and no launch; inside one it reads the
data-dependent counts (candidate and neighbour pairs, the momentum ops'
pair counts), which syncs, under the tally's suppression.
"""

import contextlib
import math

import torch

from sphexa_torch.util import phases

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# FP32 operations per candidate pair for the mask (3 shift adds, 3
# subtractions, 3 multiplies, 2 adds, the 2h compare, the self compare;
# the symmetric cutoff, tested on the pairs the mask kept, a multiply and
# a compare per neighbour pair) and per neighbour
# pair for the op's body (an FMA counts 2; the kernel polynomial is 13
# FMAs + 4 for its argument, clamp and floor = 30). The list walk adds
# each candidate's shift once, where it stages it (SHIFT_OPS per marked
# lane), and a walk that reads a kept mask computes the separation and
# d^2 only of the pairs the mask kept (GEOM_OPS: 3 subtractions, 3
# multiplies, 2 adds)
MASK_OPS = 12
SYM_OPS = 2
SHIFT_OPS = 3
GEOM_OPS = 8
# The VE bodies, counted the same way from csrc/pair_ops.cuh (an rsqrt,
# sqrt or expf counts 1; the dterh polynomial 29, as W's without its
# floor; each IAD projection (C r) w is 18), the operations every pair
# under the mask runs:
# - ve_def_gradh: u 1 + W 30 + dterh 29 + 3 FMA sums 6 = 66;
# - iad_divv_curlv: -W 32 + projection 18 + 3 velocity differences +
#   divergence 7 + three curl components 15 = 75; with gradv the nine
#   sums xm v_a tA_b 27 instead of 22 = 80;
# - av_switches: w 33 + 3 differences + r.v 5 + rsqrt 1 + signal
#   velocity 6 + projection 18 + factor 2 + 3 FMA sums 6 = 74;
# - momentum_energy_ve: u_i, u_j 2 + w_i, w_j 64 + 3 differences + r.v 5
#   + rsqrt 1 + w_ij, c_ij 2 + v_sig 5 + visc 2 + max 3 + two projections
#   36 + Atwood number 4 and its two compares 2 + viscous weights 4 + av
#   terms 12 + viscous energy 6 + energy 8 + pressure weights 4 + three
#   momentum sums 15 = 178; av_clean adds 45 (two r.G r 28, eta_ab 3 and
#   its compare 1, A and phi 10, the r.v update 3) = 223.
# A wendland-c6 form evaluates a degree-19 polynomial (csrc/pair_ops.cuh
# NCOEF_WENDLAND): 6 more FMAs, 12 operations, per evaluation (POLY_EVALS
# a pair: W, and grad-h's dterh).
POLY_EVALS = {"density": 1, "iad": 1, "momentum_energy_std": 2, "ve_def_gradh": 2,
              "iad_divv_curlv": 1, "iad_divv_curlv_gradv": 1, "av_switches": 1,
              "momentum_energy_ve": 2, "momentum_energy_ve_clean": 2}
BODY_OPS = {"density": 32, "iad": 32 + 18, "momentum_energy_std": 2 * 30 + 96,
            "ve_def_gradh": 66, "iad_divv_curlv": 75, "iad_divv_curlv_gradv": 80,
            "av_switches": 74, "momentum_energy_ve": 178, "momentum_energy_ve_clean": 223}
# operations only the pairs that take a branch run (counted per pair by
# ``pair_engine.momentum_pair_counts``): the Atwood ramp (sigma 2, dl 1, the exponent
# and its negation 2, two expf 2, two products 2), the crossed volume
# element (1 product), the av_clean limiter (eta_diff 2, its square 1,
# negation 1, expf 1)
BRANCH_OPS = {"ramp": 9, "crossed": 1, "limiter": 5}
# ops with the symmetric cutoff d^2 < 4 h_j^2 in their mask
SYM_BODIES = ("momentum_energy_std", "momentum_energy_ve", "momentum_energy_ve_clean")
# an entry point's body: its name without the list walk's suffix, and the
# av_clean forms of divv/curlv and VE momentum where the path runs them
AV_CLEAN_BODY = {"iad_divv_curlv": "iad_divv_curlv_gradv",
                 "momentum_energy_ve": "momentum_energy_ve_clean"}


def body_of(op: str, av_clean: bool = False) -> str:
    body = op[:-len("_lists")] if op.endswith("_lists") else op
    return AV_CLEAN_BODY.get(body, body) if av_clean else body

# FP32 operations per lane of the mark pass (2 run-bound compares, 3 shift
# adds, 6 bbox compares)
MARK_OPS = 11
# integer operations of the list build's merge and prune (K5): per window
# cell, log2(W3) compares of a comparison sort (the counting rank the
# kernel runs does W3) and 8 for the merge (the link's shift and gap
# tests, the run_cap test, the run end); per slot of a group's chunks, 8
# for the prune (kept, head, the two scans' adds, the pruned bounds)
MERGE_CELL_OPS = 8
PRUNE_SLOT_OPS = 8
# bytes of one window cell in the cull tables K5 reads: int64 start and
# length, the bool verdict, three float32 shifts
CULL_CELL_BYTES = 8 + 8 + 1 + 12
# distinct float32 per-particle arrays each op reads and writes (each read
# or written once), besides the run tables (5 x NG x W3 + NG words): the
# precombined i-fields, the j-fields the i-side lacks, and the outputs
IO_ARRAYS = {"density": (6, 2), "iad": (6, 6), "momentum_energy_std": (21, 5),
             "ve_def_gradh": (7, 2), "iad_divv_curlv": (16, 2),
             "iad_divv_curlv_gradv": (16, 8), "av_switches": (19, 1),
             "momentum_energy_ve": (24, 5), "momentum_energy_ve_clean": (31, 5)}

# K12 (the near-field function, traversal.py pair_body), per candidate
# pair: the geometry and self test (3 subtractions, d^2 5, the self
# compare) = 9; the body: h_i + h_j, its square, two max, rsqrt, w 3, four
# products 4, four float32 accumulations 4 = 16.
GRAV_MASK_OPS = 9
GRAV_BODY_OPS = 16
# K13 per packed slot: the class shift, two class compares, its rank in
# its class (a running count: about four integer operations a slot), the
# cap compare, the value mask and the store index = 10 integer
# operations, at the INT32 rate (half the FP32 rate)
COMPACT_OPS = 10
# its one-row form per row: the flag's compare, its bit, its share of the
# popcount rank and its position = 4 integer operations
COMPACT_ROW_OPS = 4
PEAK_INT32_OPS = PEAK_FP32_FLOPS / 2
# the lanes of a chunk of a run (sph/pair_engine.LANES; the tests hold
# them equal)
LANES = 128


def _bound(ops, nbytes) -> dict:
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def body_ops(op: str, body: str, nb_pairs: int, pairs=None, ncoef: int = 14) -> int:
    """Operations of an op's body in this run: BODY_OPS per pair it runs
    on (``ncoef`` polynomial coefficients: 2 (ncoef - 14) more per
    evaluation), plus BRANCH_OPS per pair that takes a branch. A body
    without the symmetric cutoff runs on the ``nb_pairs`` neighbour pairs
    (d^2 < 4 h_i^2); a momentum op on its own counted pairs (``pairs``,
    from ``pair_engine.momentum_pair_counts``)."""
    per_pair = BODY_OPS[body] + 2 * (ncoef - 14) * POLY_EVALS[body]
    if body not in SYM_BODIES:
        return nb_pairs * per_pair
    if pairs is None:
        raise AssertionError(f"{op}: no pair counts under its symmetric cutoff")
    return pairs["pairs"] * per_pair + sum(
        BRANCH_OPS[k] * v for k, v in pairs.items() if k in BRANCH_OPS)


def bounds(ranges, n: int, group: int, nb_pairs: int,
           ops=("density", "iad", "momentum_energy_std"), pairs=None, ncoef: int = 14):
    """Least device time of each streaming-engine op from this run's
    candidate and neighbour pair counts (operations: the mask per candidate
    pair, the symmetric cutoff per neighbour pair where the op has one, the
    body; ``pairs``: each momentum op's counts, by op) and its input/output
    bytes. Given the lists' pruned runs, the bound of K1 over them (list
    mode's form before the walk carried every op)."""
    cand_pairs = int(ranges.lens.to(torch.int64).sum()) * group
    ng, w3 = ranges.starts.shape
    table_bytes = 4 * (5 * ng * w3 + ng)
    out = {}
    for op in ops:
        body = body_of(op)
        sym = SYM_OPS * nb_pairs if body in SYM_BODIES else 0
        n_in, n_out = IO_ARRAYS[body]
        work = body_ops(op, body, nb_pairs, (pairs or {}).get(op), ncoef)
        out[op] = {**_bound(cand_pairs * MASK_OPS + sym + work,
                            4 * n * (n_in + n_out) + table_bytes),
                   "cand_pairs": cand_pairs, "body_ops": work}
    return out


def list_bounds(lists, n: int, group: int, nb_pairs: int, mark=None,
                walk_ops=("density_lists", "iad_lists", "momentum_energy_std_lists"),
                av_clean=False, pairs=None, ncoef: int = 14):
    """Least device time of the list-mode kernels from this run's counts,
    for the work each walk does in its path's mask mode (``walk_mask``):
    every walk shifts each marked lane once (SHIFT_OPS) and reads its
    fields, the run tables and the mark bits; density runs the mask on
    every candidate pair (MASK_OPS less the shift) and writes the kept
    words; a walk after it reads the words, computes the geometry of the
    pairs they keep (GEOM_OPS), the symmetric cutoff on those pairs if it
    has one (SYM_OPS) and its body on the pairs it keeps. Beside it, for a
    walk that reads, the bound of the same walk running its own mask
    (``own_mask_bound_ms``) and each op's pruned-run bound (``bounds``
    over the lists' runs: K1's form of list mode before the walk carried
    every op) and, given K5's results on the same state (``mark``: its
    window of W3 cells and the lanes of the chunks it marked), the list
    build's (``mark_bound``). ``av_clean``: the path runs the av_clean
    forms; ``pairs``: each momentum op's counts, by op."""
    ng, scap = lists.cnt.shape
    lanes = int(lists.cnt.to(torch.int64).sum())
    word_bytes = 4 * int(lists.word_off[-1]) * group
    walk_tables = 4 * (5 * ng * scap + ng) + 16 * ng * scap  # run tables, mark bits
    pruned = bounds(lists.ranges, n, group, nb_pairs,
                    ops=[body_of(op, av_clean) for op in walk_ops],
                    pairs={body_of(op, av_clean): v for op, v in (pairs or {}).items()},
                    ncoef=ncoef)
    cand_pairs = lanes * group
    mask_ops = cand_pairs * (MASK_OPS - SHIFT_OPS)
    out = {}
    for op in walk_ops:
        body = body_of(op, av_clean)
        n_in, n_out = IO_ARRAYS[body]
        work = body_ops(op, body, nb_pairs, (pairs or {}).get(op), ncoef)
        io = 4 * n * (n_in + n_out) + walk_tables
        sym = SYM_OPS * nb_pairs if body in SYM_BODIES else 0
        staged = lanes * SHIFT_OPS + work + sym
        if body == "density":  # "write": the mask, its words written
            entry = _bound(staged + mask_ops, io + word_bytes)
        else:  # "read": the kept words for the mask
            entry = {**_bound(staged + nb_pairs * GEOM_OPS, io + word_bytes),
                     "own_mask_bound_ms": _bound(staged + mask_ops, io)["bound_ms"]}
        out[op] = {**entry, "mask_mode": "write" if body == "density" else "read",
                   "cand_pairs": cand_pairs, "body_ops": work, "word_bytes": word_bytes,
                   "pruned_run_bound_ms": pruned[body]["bound_ms"],
                   "pruned_run_cand_pairs": pruned[body]["cand_pairs"]}
    if mark is not None:
        out["mark"] = mark_bound(n, ng, mark["w3"], scap, mark["lanes_visited"])
    return out


def mark_bound(n: int, ng: int, w3: int, scap: int, lanes: int) -> dict:
    """Least device time of the list build (K5) at these sizes: it reads
    the cull tables once (CULL_CELL_BYTES a cell), x, y, z and h once
    (each candidate row's reuse by the neighbouring groups that visit it
    assumed: from L2 or better) and the skin, and writes the five pruned
    run tables, the words and counts ((NG, S_cap) each; the words 16 bytes
    a slot) and the run counts and chunk totals; it runs MARK_OPS FP32
    operations on each of the ``lanes`` of the chunks it marks, and the
    merge and prune's integer operations at the INT32 rate. Beside it, the
    bound without that reuse (every visited lane's x, y, z from memory)."""
    table_bytes = CULL_CELL_BYTES * ng * w3 + 4 * 4 * n + 4 + (20 + 16 + 4) * ng * scap + 8 * ng
    int_ops = ng * w3 * (math.log2(w3) + MERGE_CELL_OPS) + lanes // LANES * PRUNE_SLOT_OPS
    ops = lanes * MARK_OPS + int_ops * PEAK_FP32_FLOPS / PEAK_INT32_OPS
    no_reuse = table_bytes - 3 * 4 * n + 3 * 4 * lanes
    return {**_bound(ops, table_bytes), "lanes": lanes, "int_ops": int_ops,
            "no_reuse_bytes": no_reuse, "no_reuse_bound_ms": 1e3 * max(
                ops / PEAK_FP32_FLOPS, no_reuse / PEAK_HBM_BYTES)}


def p2p_bound(lens, n: int, group: int) -> dict:
    """Least device time of one K12 launch: this solve's candidate pairs
    (the sum of the leaf lengths x the block's targets) x the geometry and
    body operations; x, y, z, m, h and the four outputs once, the leaf
    range tables."""
    cand = int(lens.to(torch.int64).sum()) * group
    return {**_bound(cand * (GRAV_MASK_OPS + GRAV_BODY_OPS),
                     4 * n * (5 + 4) + 2 * 4 * lens.numel() + 4 * lens.shape[0]),
            "cand_pairs": cand}


def k13_bound(parts) -> dict:
    """Least device time of K13's launches over ``parts`` ((packed, cap0,
    cap1) each): the packed words read once, the lists and counts written
    once; integer operations."""
    slots = sum(int(p.numel()) for p, _, _ in parts)
    nbytes = 4 * slots + sum(4 * p.shape[0] * (c0 + c1 + 2) for p, c0, c1 in parts)
    t_ops, t_bytes = slots * COMPACT_OPS / PEAK_INT32_OPS, nbytes / PEAK_HBM_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": slots * COMPACT_OPS, "bytes": nbytes, "slots": slots}


def gravity_bounds(lens, n: int, group: int, packed, runs=None) -> dict:
    """Least device time of K12 (``p2p_bound``) and of K13's two launches
    in one solve, together and each (``k13_bound``). Given the leaf ranges
    merged into runs (``runs``, the plain version's form), asserts that
    they hold the same candidates."""
    k12 = p2p_bound(lens, n, group)
    cand = k12["cand_pairs"]
    if runs is not None and int(runs.lens.to(torch.int64).sum()) * group != cand:
        raise AssertionError(f"K12: {cand} candidate pairs over the leaf ranges, "
                             f"{int(runs.lens.to(torch.int64).sum()) * group} over the runs")
    k13 = {**k13_bound(packed), "shapes": [list(p.shape) + [c0, c1] for p, c0, c1 in packed],
           "per_launch": [k13_bound([pk]) for pk in packed]}
    return {"gravity_p2p": k12, "compact_class_lists": k13}


def p2p_jdata_bound(lens, n: int, nj: int, group: int) -> dict:
    """Least device time of one K12 jdata launch: this rank's candidate
    pairs (the sum of the leaf lengths x the block's targets) x the
    geometry and body operations; the targets' x, y, z, h (n rows), the
    j-buffer's five fields (nj rows) and the four outputs once each, the
    range tables."""
    cand = int(lens.to(torch.int64).sum()) * group
    nbytes = 4 * n * (4 + 4) + 4 * nj * 5 + 2 * 4 * lens.numel() + 4 * lens.shape[0]
    return {**_bound(cand * (GRAV_MASK_OPS + GRAV_BODY_OPS), nbytes), "cand_pairs": cand,
            "j_rows": nj}


# ---------------------------------------------------------------------------
# the charges at the dispatch sites
# ---------------------------------------------------------------------------

_NULL = contextlib.nullcontext()


def charging():
    """The dispatch of one kernel, or of its plain version: while a tally
    runs, none of the aten ops inside are charged (the kernel's rule is,
    by the ``charge_*`` call after it); else a null context."""
    t = phases._TALLY
    return _NULL if t is None else t.suppressed()


def kernel_charge(name: str, ops: float, nbytes: float, dtype: str = "float32",
                  counts=None, outs=None) -> None:
    """Charge one launch of kernel ``name`` (its ``pair_engine.LAUNCHES``
    key) to the phase open now: ``ops`` operations of ``dtype`` and
    ``nbytes`` of memory traffic, both bounds (``counts``: the counts
    they came from, logged; ``outs``: the launch's outputs, born at its
    token). A no-op without a tally."""
    t = phases._TALLY
    if t is not None:
        t.charge_kernel(name, ops, nbytes, dtype, counts, outs)


def _charge(name, cost, dtype="float32", outs=None):
    """Charge ``name`` by ``cost()`` -> (ops, bytes), computed under the
    tally's suppression; a flag read without a tally."""
    t = phases._TALLY
    if t is None:
        return
    with t.suppressed():
        ops, nbytes = cost()
    kernel_charge(name, ops, nbytes, dtype, outs=outs)


class _NullCollective:
    """``collective``'s scope without a tally: ``done`` passes its value on."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def done(self, out, peer=None):
        return out

    def done_p2p(self, sends, recvs):
        return [r for _, r in recvs]


_NULL_COLLECTIVE = _NullCollective()


def collective(mesh, op: str, *ins, reduce: str = ""):
    """The scope of one collective of parallel/mesh.py (``op`` over
    ``mesh``'s group, ``ins`` its logical operands): while a tally runs,
    nothing inside is charged and the scope's ``done(result)`` (or
    ``done_p2p``) records the collective; else a null scope."""
    t = phases._TALLY
    return _NULL_COLLECTIVE if t is None else t.collective(mesh, op, ins, reduce)


#: an engine op's body by its spec's name and template form
_VARIANT_BODY = {("iad_divv_curlv", 1): "iad_divv_curlv_gradv",
                 ("momentum_energy_ve", 1): "momentum_energy_ve_clean"}


def spec_body(spec) -> str:
    """The body an engine op's spec runs (its name, or its template form's)."""
    return _VARIANT_BODY.get((spec.name, spec.variant), spec.name)


def pair_cost(spec, ranges, i_fields, j_fields, consts, group, lists=None, mask="own",
              nb_pairs=None, pairs=None):
    """(ops, bytes) of one K1 launch (``lists`` None: the streaming engine
    over ``ranges``; a j-buffer longer than the targets, the jdata form,
    adds its extra rows' j-fields) or K6 launch (the list walk in its
    ``mask`` mode: "write" and "own" run the mask on every marked lane,
    "read" reads the kept words), from ``bounds`` and ``list_bounds``'
    formulas at this launch's counts."""
    n, nj = i_fields[0].shape[0], j_fields[0].shape[0]
    body = spec_body(spec)
    ncoef = len(consts["coeffs"])
    if lists is None:
        b = bounds(ranges, n, group, nb_pairs, ops=(body,), pairs={body: pairs}, ncoef=ncoef)
        return b[body]["ops"], b[body]["bytes"] + 4 * (nj - n) * spec.num_j
    ng, scap = lists.cnt.shape
    lanes = int(lists.cnt.to(torch.int64).sum())
    n_in, n_out = IO_ARRAYS[body]
    work = body_ops(body, body, nb_pairs, pairs, ncoef)
    sym = SYM_OPS * nb_pairs if body in SYM_BODIES else 0
    staged = lanes * SHIFT_OPS + work + sym
    io = 4 * n * (n_in + n_out) + 4 * (5 * ng * scap + ng) + 16 * ng * scap
    if mask == "read":
        word_bytes = 4 * int(lists.word_off[-1]) * group
        return staged + nb_pairs * GEOM_OPS, io + word_bytes
    mask_ops = lanes * group * (MASK_OPS - SHIFT_OPS)
    word_bytes = 4 * int(lists.word_off[-1]) * group if mask == "write" else 0
    return staged + mask_ops, io + word_bytes


def list_build_cost(cull, n: int, total, slot_cap: int):
    """(ops, bytes) of one K5 launch: ``mark_bound`` at the cull's groups
    and window and the lanes of the chunks it marks (``total``: each
    group's chunk count, clipped at the slot budget)."""
    ng, w3 = cull[0].shape
    lanes = int(torch.clamp(total, max=slot_cap).to(torch.int64).sum()) * LANES
    b = mark_bound(n, ng, w3, slot_cap, lanes)
    return b["ops"], b["bytes"]


def charge_list_build(cull, n: int, total, slot_cap: int, outs=None) -> None:
    """Charge one K5 launch (``pair_lists.build_lists``)."""
    _charge("mark", lambda: list_build_cost(cull, n, total, slot_cap), outs=outs)


def p2p_cost(lens, n: int, group: int, nj=None):
    """(ops, bytes) of one K12 launch over the leaf ranges ``lens``: the
    targets' own arrays, or a j-buffer of ``nj`` rows (the jdata form)."""
    if nj is None:
        b = p2p_bound(lens, n, group)
    else:
        b = p2p_jdata_bound(lens, n, nj, group)
    return b["ops"], b["bytes"]


def charge_p2p(lens, n: int, group: int, nj=None, outs=None) -> None:
    """Charge one K12 launch (``traversal._pallas_p2p``)."""
    _charge("gravity_p2p", lambda: p2p_cost(lens, n, group, nj), outs=outs)


def compact_cost(packed, cap0: int, cap1: int):
    """(integer ops, bytes) of one K13 launch (``gravity_bounds``' K13
    rule for one packed array)."""
    b = k13_bound([(packed, cap0, cap1)])
    return b["ops"], b["bytes"]


def charge_compact(packed, cap0: int, cap1: int, outs=None) -> None:
    """Charge one K13 launch (``pallas_compact.compact_class_lists``), its
    operations at the INT32 rate."""
    _charge("compact_class_lists", lambda: compact_cost(packed, cap0, cap1), "int32",
            outs=outs)


def compact_row_cost(n: int):
    """(integer ops, bytes) of one launch pair of K13's one-row form over
    ``n`` flags: COMPACT_ROW_OPS a row, the mask read and the list and
    count written."""
    return COMPACT_ROW_OPS * n, 5 * n + 4


def charge_compact_row(n: int, outs=None) -> None:
    """Charge one call of K13's one-row form (``pallas_compact.compact_row``)."""
    _charge("compact_row", lambda: compact_row_cost(n), "int32", outs=outs)
