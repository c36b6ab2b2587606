"""The static per-phase roofline cost model of the port (the JAX package's
devtools/audit/costmodel.py, jaxcost).

It predicts the per-phase device-time table that ``python -m
sphexa_torch.telemetry trace`` measures from a capture. A torch step has
no jaxpr to walk: the counterpart of "trace the step and walk its
equations" is "run the step once under a tally" (tally.py), a dispatch
mode that charges every aten op to the innermost open ``sphexa/<phase>``
scope (util/phases.py), the scopes a ``--trace-dir`` capture records.
The CUDA kernels launch through ctypes, which the dispatcher never sees:
each is charged at its dispatch site by its rule (kernels/costs.py), as
the JAX walk charges a ``pallas_call`` as a leaf.

Per op the model accumulates:

- **FLOPs** from the per-op cost rules (``FLOP_RULES`` /
  ``ELEMENTWISE_WEIGHTS`` / ``_REDUCE_OPS``), the JAX model's weights
  re-keyed by aten op name: mm/bmm from their shapes (2 M N K), sort at
  n log2 n, reductions, scans and scatters per input element,
  elementwise ops per output element (transcendentals 8, divides and
  roots 4, data movement 0, anything else 1);
- **HBM bytes** from the tensors an op reads and writes, twice: an upper
  bound (every op round-trips memory: no fusion) and a lower bound that
  charges each tensor once per phase, keyed by the tensor and its
  version (an in-place write makes a new value), the JAX model's
  same-phase fusion discount.

One difference from the JAX model: the tally counts the path the step
executed, with its data-dependent sizes, so it needs neither the JAX
walk's most-expensive ``cond`` branch nor its "while bodies counted once"
lower bound.

``predict`` divides the tallies by a devices.py model into a per-phase ms
table and classifies each phase against the ridge point; ops outside
every phase roll into ``unattributed`` and a FLOP coverage fraction.
``calibration_join`` (``trace <dir> --predict``) joins a measured capture
against the prediction of the program that produced it and gates the
per-phase measured/predicted ratios inside a committed band.
"""

import dataclasses
import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

from sphexa_torch.devtools.audit.devices import DeviceModel, get_device
from sphexa_torch.telemetry.traceview import CALIBRATION_FILE

__all__ = [
    "PhaseCost",
    "CostReport",
    "PhasePrediction",
    "Prediction",
    "op_flops",
    "report_from_tally",
    "cost_report",
    "predict",
    "memory_bound_phases",
    "load_budget",
    "validate_budget",
    "load_calibration",
    "calibration_join",
    "predict_for_target",
]

UNATTRIBUTED = "unattributed"

# ---------------------------------------------------------------------------
# per-op FLOP cost rules (aten op names: an in-place or out= variant is
# charged as its op)
# ---------------------------------------------------------------------------

#: FLOPs charged per OUTPUT element for elementwise-shaped ops. Ops absent
#: from every table below default to weight 1 (one vector op per
#: element); pure data movement is weight 0. These are the per-op cost
#: rules the calibration fixture pins: corrupting one moves a phase's
#: predicted ms outside the committed band.
ELEMENTWISE_WEIGHTS: Dict[str, float] = {
    # transcendentals: multi-pass polynomial/Newton implementations
    "exp": 8.0, "exp2": 8.0, "log": 8.0, "log1p": 8.0, "expm1": 8.0,
    "log2": 8.0, "log10": 8.0,
    "sin": 8.0, "cos": 8.0, "tan": 8.0, "tanh": 8.0, "sigmoid": 8.0,
    "erf": 8.0, "erfc": 8.0, "erfinv": 8.0, "atan2": 8.0,
    "asin": 8.0, "acos": 8.0, "atan": 8.0, "sinh": 8.0, "cosh": 8.0,
    "asinh": 8.0, "acosh": 8.0, "atanh": 8.0, "pow": 8.0,
    # divide/rsqrt-class: iterative refinement
    "div": 4.0, "sqrt": 4.0, "rsqrt": 4.0, "reciprocal": 4.0,
    "remainder": 4.0, "fmod": 4.0,
    # data movement: bytes are charged, arithmetic is not
    "_to_copy": 0.0, "copy": 0.0, "clone": 0.0, "cat": 0.0, "stack": 0.0,
    "constant_pad_nd": 0.0, "flip": 0.0, "roll": 0.0, "gather": 0.0,
    "index": 0.0, "_unsafe_index": 0.0, "index_select": 0.0, "take": 0.0,
    "take_along_dim": 0.0, "repeat": 0.0, "repeat_interleave": 0.0,
    "arange": 0.0, "full": 0.0, "zeros": 0.0, "ones": 0.0, "fill": 0.0,
    "zero": 0.0, "full_like": 0.0, "zeros_like": 0.0, "ones_like": 0.0,
    "new_zeros": 0.0, "new_ones": 0.0, "new_full": 0.0, "scalar_tensor": 0.0,
    "masked_select": 0.0,
}

#: the JAX model's ``integer_pow`` weight: ``pow`` to an integral scalar
INTEGER_POW_WEIGHT = 2.0

#: ops whose FLOPs scale with the INPUT (reduction-shaped): one op per
#: input element, every tensor operand counted (the JAX model counts the
#: scatters' indices and updates too)
_REDUCE_OPS = frozenset({
    "sum", "nansum", "mean", "prod", "amax", "amin", "max", "min",
    "aminmax", "argmax", "argmin", "any", "all", "count_nonzero", "nonzero",
    "norm", "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
    "logsumexp", "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "scatter", "scatter_add", "scatter_reduce", "index_add", "index_reduce",
    "index_put", "index_copy", "index_fill", "masked_scatter", "bincount",
    "histc", "equal",
})

#: overloads of reduction names that are elementwise (``max(a, b)``)
_ELEMENTWISE_OVERLOADS = frozenset({"other", "binary_out"})


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _mm_flops(ins, outs, args) -> float:
    # (B,) M x K times (B,) K x N: 2 B M N K
    a, b = ins[0], ins[1]
    return 2.0 * _numel(a.shape) * int(b.shape[-1])


def _addmm_flops(ins, outs, args) -> float:
    # bias + a @ b: the product, and one add per output element
    a, b = ins[1], ins[2]
    return 2.0 * _numel(a.shape) * int(b.shape[-1]) + _numel(outs[0].shape)


def _mv_flops(ins, outs, args) -> float:
    return 2.0 * _numel(ins[0].shape)


def _sort_flops(ins, outs, args) -> float:
    n = sum(_numel(t.shape) for t in ins)
    return float(n) * max(math.log2(max(n, 2)), 1.0)


#: op name -> flops(input tensors, output tensors, args); consulted first
FLOP_RULES: Dict[str, Any] = {
    "mm": _mm_flops,
    "bmm": _mm_flops,
    "addmm": _addmm_flops,
    "baddbmm": _addmm_flops,
    "mv": _mv_flops,
    "dot": _mv_flops,
    "sort": _sort_flops,
    "argsort": _sort_flops,
    "msort": _sort_flops,
}


def op_name(func) -> str:
    """An aten op's rule name: its overload packet's, an in-place
    variant's trailing underscore dropped (``add_`` is charged as
    ``add``)."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


def op_flops(func, ins, outs, args) -> float:
    """Per-op FLOP estimate of one aten call: ``ins`` / ``outs`` its tensor
    operands and results, ``args`` its positional arguments."""
    name = op_name(func)
    rule = FLOP_RULES.get(name)
    if rule is not None:
        return float(rule(ins, outs, args))
    if name in _REDUCE_OPS and func._overloadname not in _ELEMENTWISE_OVERLOADS:
        return float(sum(_numel(t.shape) for t in ins))
    weight = ELEMENTWISE_WEIGHTS.get(name, 1.0)
    if name == "pow" and len(args) > 1 and isinstance(args[1], (int, float)) \
            and float(args[1]).is_integer():
        weight = INTEGER_POW_WEIGHT
    return float(sum(_numel(t.shape) for t in outs)) * weight


# ---------------------------------------------------------------------------
# the per-phase accumulator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PhaseCost:
    """Accumulated static cost of one phase bucket."""

    phase: str
    flops: float = 0.0
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    hbm_lower: float = 0.0      # each tensor version once per phase
    hbm_upper: float = 0.0      # every op round-trips memory
    ici_bytes: float = 0.0
    eqns: int = 0               # ops and kernel launches charged

    def dominant_dtype(self) -> str:
        if not self.flops_by_dtype:
            return "float32"
        return max(self.flops_by_dtype.items(), key=lambda kv: kv[1])[0]


@dataclasses.dataclass
class CostReport:
    """Per-phase static cost of one tallied entry."""

    phases: Dict[str, PhaseCost]      # taxonomy phases + any unknown scopes
    unattributed: PhaseCost           # ops outside every sphexa/ scope
    unknown_scopes: Tuple[str, ...]   # sphexa/<x> with x outside PHASES
    total_flops: float
    coverage: float                   # on-taxonomy FLOP share (1.0 if 0 FLOPs)
    #: kernel launches charged, by ``pair_engine.LAUNCHES`` key
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)


class _Acc:
    """Mutable tally state: phase buckets + per-phase fusion seen-sets."""

    def __init__(self) -> None:
        self.buckets: Dict[str, PhaseCost] = {}
        self._seen: Dict[str, set] = {}

    def bucket(self, phase: str) -> PhaseCost:
        b = self.buckets.get(phase)
        if b is None:
            b = self.buckets[phase] = PhaseCost(phase=phase)
            self._seen[phase] = set()
        return b

    def add(self, phase: str, flops: float, dtype: str, io, ici: float = 0.0) -> None:
        """Charge one op: ``io`` its (key, bytes) operands and results; a
        key seen before in the phase adds to the upper bound only."""
        b = self.bucket(phase)
        b.eqns += 1
        b.flops += flops
        if flops:
            b.flops_by_dtype[dtype] = b.flops_by_dtype.get(dtype, 0.0) + flops
        b.ici_bytes += ici
        seen = self._seen[phase]
        for key, nb in io:
            b.hbm_upper += nb
            if key not in seen:
                seen.add(key)
                b.hbm_lower += nb

    def add_fused(self, phase: str, flops: float, dtype: str, nbytes: float) -> None:
        """Charge one fused unit (a kernel launch): its bytes are both
        bounds."""
        b = self.bucket(phase)
        b.eqns += 1
        b.flops += flops
        if flops:
            b.flops_by_dtype[dtype] = b.flops_by_dtype.get(dtype, 0.0) + flops
        b.hbm_upper += nbytes
        b.hbm_lower += nbytes


def report_from_tally(tally) -> CostReport:
    """Fold one tally (tally.py) into a per-phase ``CostReport``."""
    from sphexa_torch.util.phases import PHASES

    buckets = dict(tally.acc.buckets)
    taxonomy = set(PHASES)
    unattributed = buckets.pop("", None)
    unattributed = dataclasses.replace(unattributed, phase=UNATTRIBUTED) \
        if unattributed is not None else PhaseCost(phase=UNATTRIBUTED)
    unknown = tuple(sorted(p for p in buckets if p not in taxonomy))
    total = sum(b.flops for b in buckets.values()) + unattributed.flops
    on_tax = sum(b.flops for p, b in buckets.items() if p in taxonomy)
    return CostReport(
        phases=dict(sorted(buckets.items())),
        unattributed=unattributed,
        unknown_scopes=unknown,
        total_flops=total,
        coverage=(on_tax / total) if total > 0 else 1.0,
        kernels=dict(tally.kernels),
    )


def cost_report(trace, ctx=None) -> CostReport:
    """Cached per-entry report: one tallied run per ``EntryTrace``, shared
    by every JXA3xx rule and the cost CLI."""
    cached = getattr(trace, "_cost_report", None)
    if cached is not None:
        return cached
    report = report_from_tally(trace.tally)
    trace._cost_report = report
    return report


# ---------------------------------------------------------------------------
# roofline prediction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhasePrediction:
    phase: str
    flops: float
    hbm_lower: float
    hbm_upper: float
    ici_bytes: float
    ai: float              # FLOPs / fused (lower-bound) HBM bytes
    compute_ms: float
    hbm_ms: float          # fused bytes / HBM BW
    hbm_ms_upper: float    # unfused bytes / HBM BW
    ici_ms: float
    ms: float              # roofline headline: max(compute, hbm, ici)
    ms_upper: float
    bound: str             # "compute" | "memory" | "ici"
    dtype: str

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Prediction:
    device: str
    rows: Tuple[PhasePrediction, ...]   # phases sorted by headline ms desc
    unattributed: PhasePrediction
    total_ms: float                     # all buckets, headline bound
    total_ms_upper: float
    coverage: float
    unknown_scopes: Tuple[str, ...]

    def row(self, phase: str) -> Optional[PhasePrediction]:
        if phase == UNATTRIBUTED:
            return self.unattributed
        return next((r for r in self.rows if r.phase == phase), None)


def _predict_bucket(b: PhaseCost, dev: DeviceModel) -> PhasePrediction:
    compute_s = sum(f / dev.peak_for(d) for d, f in b.flops_by_dtype.items())
    hbm_s = b.hbm_lower / dev.hbm_bytes_per_s
    hbm_up_s = b.hbm_upper / dev.hbm_bytes_per_s
    ici_s = b.ici_bytes / dev.ici_bytes_per_s
    ms = max(compute_s, hbm_s, ici_s) * 1e3
    ms_upper = max(compute_s, hbm_up_s, ici_s) * 1e3
    if ici_s >= max(compute_s, hbm_s):
        bound = "ici"
    elif compute_s >= hbm_s:
        bound = "compute"
    else:
        bound = "memory"
    return PhasePrediction(
        phase=b.phase, flops=b.flops, hbm_lower=b.hbm_lower,
        hbm_upper=b.hbm_upper, ici_bytes=b.ici_bytes,
        ai=b.flops / b.hbm_lower if b.hbm_lower > 0 else float("inf"),
        compute_ms=compute_s * 1e3, hbm_ms=hbm_s * 1e3,
        hbm_ms_upper=hbm_up_s * 1e3, ici_ms=ici_s * 1e3,
        ms=ms, ms_upper=ms_upper, bound=bound, dtype=b.dominant_dtype(),
    )


def predict(report: CostReport, device) -> Prediction:
    """Classify a ``CostReport`` against a device model (name or
    ``DeviceModel``) into the predicted per-phase ms table."""
    dev = device if isinstance(device, DeviceModel) else get_device(device)
    rows = tuple(sorted(
        (_predict_bucket(b, dev) for b in report.phases.values()),
        key=lambda r: -r.ms))
    un = _predict_bucket(report.unattributed, dev)
    return Prediction(
        device=dev.name, rows=rows, unattributed=un,
        total_ms=sum(r.ms for r in rows) + un.ms,
        total_ms_upper=sum(r.ms_upper for r in rows) + un.ms_upper,
        coverage=report.coverage, unknown_scopes=report.unknown_scopes,
    )


def memory_bound_phases(pred: Prediction, dev: Optional[DeviceModel] = None,
                        ) -> List[PhasePrediction]:
    """Phases whose arithmetic intensity sits below the device ridge
    point, heaviest first."""
    dev = dev or get_device(pred.device)
    return [r for r in pred.rows if r.ai < dev.ridge(r.dtype)]


# ---------------------------------------------------------------------------
# the committed per-phase budget file
# ---------------------------------------------------------------------------

BUDGET_SCHEMA = 1


def validate_budget(doc: Any) -> List[str]:
    """Schema errors of a budget document (COST_BUDGET_TORCH.json); []
    when valid."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["budget document is not a JSON object"]
    if doc.get("schema") != BUDGET_SCHEMA:
        errs.append(f"schema must be {BUDGET_SCHEMA}, got {doc.get('schema')!r}")
    try:
        get_device(str(doc.get("device")))
    except ValueError as e:
        errs.append(str(e))
    entries = doc.get("entries")
    if not isinstance(entries, dict) or not entries:
        errs.append("entries must be a non-empty object keyed by entry name")
        return errs
    for name, spec in entries.items():
        if not isinstance(spec, dict):
            errs.append(f"{name}: entry spec is not an object")
            continue
        phases = spec.get("phases")
        if not isinstance(phases, dict) or not phases:
            errs.append(f"{name}: phases must be a non-empty object")
            continue
        for ph, ms in phases.items():
            if not isinstance(ms, (int, float)) or ms <= 0:
                errs.append(f"{name}: phase {ph!r} budget must be a "
                            f"positive number, got {ms!r}")
        total = spec.get("total_ms")
        if total is not None and (not isinstance(total, (int, float))
                                  or total <= 0):
            errs.append(f"{name}: total_ms must be a positive number")
    return errs


def load_budget(path: str) -> Dict[str, Any]:
    """Load + validate a budget file; raises ``ValueError`` with every
    schema problem (a broken gate must not pass silently)."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    errs = validate_budget(doc)
    if errs:
        raise ValueError(f"{path}: " + "; ".join(errs))
    return doc


# ---------------------------------------------------------------------------
# calibration against a measured capture (trace --predict)
# ---------------------------------------------------------------------------

def load_calibration(trace_dir: str) -> Optional[Dict[str, Any]]:
    """The capture's committed calibration declaration, or None. Format::

        {"schema": 1,
         "target": "scripts/make_torch_trace_fixture.py::trace_fixture",
         "device": "cpu-smoke", "tolerance": 2.0,
         "phases": {"density": {"ratio": 123.4}, ...}}

    ``ratio`` is the recorded measured_us / predicted_us of the phase; the
    gate holds while fresh ratios stay within ``tolerance`` x of it.
    """
    path = os.path.join(trace_dir, CALIBRATION_FILE)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    errs: List[str] = []
    if not isinstance(doc.get("target"), str) or "::" not in doc["target"]:
        errs.append("target must be '<module-or-file>::<entry-name>'")
    try:
        get_device(str(doc.get("device")))
    except ValueError as e:
        errs.append(str(e))
    phases = doc.get("phases")
    if not isinstance(phases, dict) or not phases:
        errs.append("phases must be a non-empty object")
    else:
        for ph, spec in phases.items():
            r = spec.get("ratio") if isinstance(spec, dict) else None
            if not isinstance(r, (int, float)) or r <= 0:
                errs.append(f"phase {ph!r}: ratio must be a positive number")
    tol = doc.get("tolerance", 2.0)
    if not isinstance(tol, (int, float)) or tol <= 1.0:
        errs.append("tolerance must be a number > 1")
    if errs:
        raise ValueError(f"{path}: " + "; ".join(errs))
    return doc


def predict_for_target(target: str, device: str) -> Prediction:
    """Build and tally a registry target (``<module-or-file>::<entry>``)
    and predict it."""
    mod_name, _, entry_name = target.partition("::")
    from sphexa_torch.devtools.audit.cli import _load_target
    from sphexa_torch.devtools.audit.core import EntryTrace, entries_from_namespace

    mod = _load_target(mod_name)
    entries = {e.name: e for e in entries_from_namespace(vars(mod))}
    if entry_name not in entries:
        raise ValueError(f"{mod_name}: no @entrypoint named {entry_name!r} "
                         f"(has: {sorted(entries)})")
    entry = entries[entry_name]
    trace = EntryTrace(entry, entry.build())
    return predict(cost_report(trace), device)


def calibration_join(summary: Dict[str, Any], calib: Dict[str, Any],
                     ) -> Dict[str, Any]:
    """Join a traceview summary against the static prediction of the
    calibration target; returns rows + band violations.

    A calibrated phase missing from either side is a violation: the
    capture and the program drifting apart is exactly the failure this
    gate exists to catch.
    """
    pred = predict_for_target(calib["target"], calib["device"])
    tol = float(calib.get("tolerance", 2.0))
    measured = {p["phase"]: float(p["us"]) for p in summary.get("phases", ())}
    rows: List[Dict[str, Any]] = []
    violations: List[str] = []
    for phase, spec in sorted(calib["phases"].items()):
        ref = float(spec["ratio"])
        lo, hi = ref / tol, ref * tol
        row: Dict[str, Any] = {"phase": phase, "ref_ratio": ref,
                               "band": [lo, hi]}
        prow = pred.row(phase)
        mus = measured.get(phase)
        if prow is None or prow.ms <= 0:
            row["status"] = "no-prediction"
            violations.append(f"{phase}: no static prediction for the "
                              f"calibration target")
        elif mus is None:
            row["status"] = "no-measurement"
            violations.append(f"{phase}: absent from the measured capture")
        else:
            row["measured_us"] = mus
            row["predicted_us"] = prow.ms * 1e3
            ratio = mus / (prow.ms * 1e3)
            row["ratio"] = ratio
            row["status"] = "ok" if lo <= ratio <= hi else "out-of-band"
            if row["status"] != "ok":
                violations.append(
                    f"{phase}: measured/predicted ratio {ratio:.3g} outside "
                    f"[{lo:.3g}, {hi:.3g}] (recorded {ref:.3g} x tolerance "
                    f"{tol:g}) — the cost rules drifted from the capture")
        rows.append(row)
    return {
        "target": calib["target"],
        "device": calib["device"],
        "tolerance": tol,
        "rows": rows,
        "violations": violations,
        "ok": not violations,
    }
