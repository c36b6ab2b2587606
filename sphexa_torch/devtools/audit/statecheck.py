"""statecheck of the port (the JAX package's devtools/audit/statecheck.py):
the state-schema lock and the vmap-batchability report.

    python -m sphexa_torch.devtools.audit schema [targets] [--lock F] [--diff]
        [--write] [--vmap] [--entries ...] [--json] [--cpu]

Where the lowering lock pins what each entry runs, statecheck pins what it
returns: the output of each entry's recorded run is flattened into
per-leaf rows (path, dtype, and each axis as a polynomial in the particle
count N), fitted exactly in rational arithmetic from the entry's two-point
``grow`` probe (the entry rebuilt larger, side 8 against the registry's 6:
``grow`` 64/27 for the cube, as the JAX lock records). ``const`` axes do
not scale, ``extensive`` axes are a N, ``affine`` a N + b, anything else
is ``data`` with both sizes seen. A sharded entry's row holds one such
row a rank (``{"mesh": P, "ranks": [...]}``, locked at P = 2). A path is
the JAX package's
``keystr``: ``[i]`` a tuple or list item, ``['k']`` a dict key, ``.f`` a
dataclass field; a ``None`` is no leaf, as in a pytree. The rows of the
registry live in the committed ``STATE_SCHEMA_TORCH.json``; drift exits
1 with a per-leaf diff and is re-locked with ``--write``.

``--vmap`` adds the JXA502 report: each entry runs under
``torch.func.vmap`` over a member axis (every tensor of its args stacked
``--members`` times) and what breaks batching (a failure, a host read, a
kernel launch inside the vmapped body) is a finding, not a crash. It is
not part of the default gate.
"""

import argparse
import dataclasses
import json
import sys
from fractions import Fraction
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "SCHEMA_VERSION",
    "DEFAULT_SCHEMA_PATH",
    "LockError",
    "flatten",
    "entry_schema",
    "vmap_probe",
    "load_lock",
    "write_lock",
    "schema_diff",
    "row_diff",
    "format_axes",
    "main",
]

SCHEMA_VERSION = 1
DEFAULT_SCHEMA_PATH = "STATE_SCHEMA_TORCH.json"

#: leaf-change rows rendered per entry in the text diff
_DIFF_LIMIT = 12


class LockError(ValueError):
    """Unreadable, corrupt or wrong-version schema lock (CLI exit 2)."""


# ---------------------------------------------------------------------------
# flattening (the pytree paths of the JAX package)
# ---------------------------------------------------------------------------


def flatten(obj, path: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] of ``obj`` in order: tensors and other values are
    leaves; tuples, lists, dicts and dataclasses are walked; ``None`` is
    kept as a leaf of its own (the structure of a carry: a slot that flips
    between ``None`` and a value changes it)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = []
        for f in dataclasses.fields(obj):
            out += flatten(getattr(obj, f.name), f"{path}.{f.name}")
        return out
    if isinstance(obj, dict):
        out = []
        for k in sorted(obj, key=str):
            out += flatten(obj[k], f"{path}[{k!r}]")
        return out
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        out = []
        for i, v in enumerate(obj):
            out += flatten(v, f"{path}[{i}]")
        return out
    if hasattr(obj, "_fields"):  # a NamedTuple: by field, as a dataclass
        out = []
        for f in obj._fields:
            out += flatten(getattr(obj, f), f"{path}.{f}")
        return out
    return [(path, obj)]


def unflatten(obj, leaves: List[Any]):
    """``obj`` with its leaves replaced, in ``flatten``'s order."""
    it = iter(leaves)

    def build(o):
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return dataclasses.replace(o, **{f.name: build(getattr(o, f.name))
                                             for f in dataclasses.fields(o) if f.init})
        if isinstance(o, dict):
            return {k: build(o[k]) for k in sorted(o, key=str)}
        if hasattr(o, "_fields"):
            return type(o)(*[build(getattr(o, f)) for f in o._fields])
        if isinstance(o, (list, tuple)):
            return type(o)(build(v) for v in o)
        return next(it)

    return build(obj)


def _leaf_meta(leaf) -> Optional[Tuple[str, Tuple[int, ...]]]:
    """(dtype, shape) of a schema leaf, or None for a value that is not
    data (a Python int or float, a string: the JAX package's static
    fields)."""
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", ""), tuple(leaf.shape)
    if isinstance(leaf, np.ndarray):
        return f"numpy.{leaf.dtype}", tuple(leaf.shape)
    return None


def _schema_leaves(obj) -> List[Tuple[str, str, Tuple[int, ...]]]:
    out = []
    for path, leaf in flatten(obj):
        meta = _leaf_meta(leaf)
        if meta is not None:
            out.append((path, *meta))
    return out


def _n_rows(args) -> int:
    """The N anchor: the largest leading dim over the entry's tensor args."""
    n = 0
    for _path, _dt, shape in _schema_leaves(args):
        if shape:
            n = max(n, int(shape[0]))
    return n


def _fit_axes(dims1, dims2, n1: int, n2: int) -> List[Dict[str, Any]]:
    """Per-axis polynomial a N + b from the two probe points, exactly."""
    axes: List[Dict[str, Any]] = []
    for d1, d2 in zip(dims1, dims2):
        d1, d2 = int(d1), int(d2)
        if d1 == d2:
            axes.append({"kind": "const", "dim": d1})
            continue
        a = Fraction(d2 - d1, n2 - n1)
        b = Fraction(d1) - a * n1
        if b == 0:
            axes.append({"kind": "extensive", "per_n": str(a)})
        elif b.denominator == 1 and a > 0:
            axes.append({"kind": "affine", "per_n": str(a), "offset": int(b)})
        else:
            axes.append({"kind": "data", "observed": [d1, d2]})
    return axes


def format_axes(axes) -> str:
    parts = []
    for ax in axes:
        kind = ax.get("kind")
        if kind == "const":
            parts.append(str(ax["dim"]))
        elif kind in ("extensive", "affine"):
            a = ax["per_n"]
            head = "N" if a == "1" else f"{a}N"
            parts.append(head if kind == "extensive" else f"{head}{int(ax['offset']):+d}")
        else:
            lo, hi = ax.get("observed", ["?", "?"])
            parts.append(f"data({lo}..{hi})")
    return "[" + ", ".join(parts) + "]"


def _fmt_leaf(leaf: Dict[str, Any]) -> str:
    return f"{leaf.get('dtype')}{format_axes(leaf.get('shape', []))}"


def entry_schema(trace) -> Dict[str, Any]:
    """The cached schema row of one entry: the output of its recorded run,
    each axis fitted against the entry's ``grow`` probe where it has one
    (``trace.grown()``: the probe's one extra build and run); a sharded
    entry's is {"mesh": P, "ranks": [each rank's row]}."""
    cached = getattr(trace, "_schema", None)
    if cached is not None:
        return cached
    if trace.sharded:
        row = {"mesh": len(trace.ranks), "ranks": [entry_schema(v) for v in trace.ranks]}
        trace._schema = row
        return row
    base = _schema_leaves(trace.out)
    n1 = _n_rows(trace.case.args)
    row: Dict[str, Any] = {"n_base": n1 or None, "grow": None, "leaves": {}}
    grown = None
    n2 = 0
    gtrace = trace.grown() if n1 else None
    if gtrace is not None:
        grown = _schema_leaves(gtrace.out)
        n2 = _n_rows(gtrace.case.args)
        if len(grown) != len(base) or n2 == n1:
            raise ValueError(f"entry {trace.entry.name}: the grow probe changed the output "
                             f"structure ({len(base)} -> {len(grown)} leaves at N {n1} -> "
                             f"{n2}): the schema is not defined")
        row["grow"] = str(Fraction(n2, n1))
    for i, (path, dtype, shape) in enumerate(base):
        if grown is not None:
            gpath, _gdt, gshape = grown[i]
            if gpath != path or len(gshape) != len(shape):
                raise ValueError(f"entry {trace.entry.name}: leaf {path} changed path or "
                                 f"rank across the grow probe")
            axes = _fit_axes(shape, gshape, n1, n2)
        else:
            axes = [{"kind": "const", "dim": int(d)} for d in shape]
        row["leaves"][path] = {"dtype": dtype, "shape": axes}
    trace._schema = row
    return row


# ---------------------------------------------------------------------------
# vmap batchability (JXA502's analysis)
# ---------------------------------------------------------------------------


def vmap_probe(trace, members: int) -> Dict[str, Any]:
    """Run the entry under ``torch.func.vmap`` over a leading member axis
    of width ``members`` (every tensor of its args stacked) and report
    what happens: the error that stopped it, and the kernels launched
    inside the vmapped body. Cached per trace."""
    cached = getattr(trace, "_vmap", None)
    if cached is not None and cached.get("members") == members:
        return cached
    import torch

    from sphexa_torch.sph.pair_engine import LAUNCHES

    flat = flatten(trace.case.args)
    pos = [i for i, (_p, leaf) in enumerate(flat) if isinstance(leaf, torch.Tensor)]
    leaves = [leaf for _p, leaf in flat]

    def body(*tensors):
        vals = list(leaves)
        for i, t in zip(pos, tensors):
            vals[i] = t
        out = trace.case.fn(*unflatten(trace.case.args, vals))
        return tuple(leaf for _p, leaf in flatten(out) if isinstance(leaf, torch.Tensor))

    batched = [torch.stack([leaves[i]] * members) for i in pos]
    report: Dict[str, Any] = {"members": members, "error": None, "launches": {}}
    before = dict(LAUNCHES)
    try:
        torch.func.vmap(body, randomness="same")(*batched)
    except Exception as e:  # noqa: BLE001 - captured as a finding
        report["error"] = f"{e.__class__.__name__}: {str(e).splitlines()[0][:300]}"
    report["launches"] = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                          if v != before.get(k, 0)}
    trace._vmap = report
    return report


# ---------------------------------------------------------------------------
# lock IO
# ---------------------------------------------------------------------------


def load_lock(path) -> Dict[str, Dict[str, Any]]:
    p = Path(path)
    try:
        payload = json.loads(p.read_text())
    except OSError as e:
        raise LockError(f"cannot read schema lock {p}: {e}") from e
    except json.JSONDecodeError as e:
        raise LockError(f"corrupt schema lock {p}: {e}") from e
    if not isinstance(payload, dict) or "entries" not in payload:
        raise LockError(f"corrupt schema lock {p}: no 'entries' object")
    if payload.get("version") != SCHEMA_VERSION:
        raise LockError(f"schema lock {p} has version {payload.get('version')!r}, this "
                        f"tool writes {SCHEMA_VERSION} (regenerate with --write)")
    return payload["entries"]


def write_lock(path, entries: Dict[str, Dict[str, Any]]) -> None:
    payload = {
        "version": SCHEMA_VERSION,
        "tool": "statecheck",
        "comment": "output schema per audit entry (axis polynomials in N from the "
                   "two-point grow probe); regenerate with: python -m "
                   "sphexa_torch.devtools.audit schema --cpu --write",
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    Path(path).write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")


# ---------------------------------------------------------------------------
# structural diff
# ---------------------------------------------------------------------------


def schema_diff(name: str, locked: Dict[str, Any], current: Dict[str, Any],
                verbose: bool = False) -> List[str]:
    """Per-leaf diff of a drifted schema row."""
    lines = [f"entry {name}: JXA501 state schema drifted from the lock"]
    lo, cu = locked.get("leaves", {}), current.get("leaves", {})
    added = sorted(set(cu) - set(lo))
    removed = sorted(set(lo) - set(cu))
    changed = sorted(p for p in set(lo) & set(cu) if lo[p] != cu[p])
    for meta in ("n_base", "grow"):
        if locked.get(meta) != current.get(meta):
            lines.append(f"  {meta}: {locked.get(meta)} -> {current.get(meta)}")
    rows = ([("+", p, None, cu[p]) for p in added] + [("-", p, lo[p], None) for p in removed]
            + [("~", p, lo[p], cu[p]) for p in changed])
    limit = len(rows) if verbose else _DIFF_LIMIT
    for mark, p, old, new in rows[:limit]:
        if mark == "+":
            lines.append(f"  + {p}: {_fmt_leaf(new)}")
        elif mark == "-":
            lines.append(f"  - {p}: {_fmt_leaf(old)}")
        else:
            lines.append(f"  ~ {p}: {_fmt_leaf(old)} -> {_fmt_leaf(new)}")
    if len(rows) > limit:
        lines.append(f"  ... {len(rows) - limit} more leaf change(s) (--diff for all)")
    lines.append(f"  summary: +{len(added)} -{len(removed)} ~{len(changed)} leaves "
                 f"(locked {len(lo)}, current {len(cu)})")
    return lines


def row_diff(name: str, locked: Dict[str, Any], current: Dict[str, Any],
             verbose: bool = False) -> List[str]:
    """``schema_diff`` of a row, a sharded row's rank by rank."""
    if "ranks" not in locked and "ranks" not in current:
        return schema_diff(name, locked, current, verbose)
    if locked.get("mesh") != current.get("mesh"):
        return [f"entry {name}: JXA501 locked at mesh {locked.get('mesh')}, recorded at "
                f"mesh {current.get('mesh')}"]
    out: List[str] = []
    for r, (lo, cu) in enumerate(zip(locked["ranks"], current["ranks"])):
        if lo != cu:
            out += schema_diff(f"{name}[rank {r}]", lo, cu, verbose)
    return out


def _delta_summary(locked: Dict[str, Any], current: Dict[str, Any]) -> Dict[str, Any]:
    if "ranks" in locked or "ranks" in current:
        return {"ranks": [_delta_summary(lo, cu) for lo, cu in
                          zip(locked.get("ranks", []), current.get("ranks", []))],
                "mesh": [locked.get("mesh"), current.get("mesh")]}
    lo, cu = locked.get("leaves", {}), current.get("leaves", {})
    return {"added": sorted(set(cu) - set(lo)), "removed": sorted(set(lo) - set(cu)),
            "changed": sorted(p for p in set(lo) & set(cu) if lo[p] != cu[p])}


# ---------------------------------------------------------------------------
# CLI: schema
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sphexa-torch-audit schema",
        description="verify every registered entry's output schema (paths, dtypes, "
                    "axis polynomials in N) against the committed "
                    "STATE_SCHEMA_TORCH.json, and that each step's state closes "
                    "(JXA503); drift exits 1 with a per-leaf diff. Re-lock an intended "
                    "change with --write. --vmap adds the JXA502 batchability report.",
    )
    ap.add_argument("targets", nargs="*", default=["sphexa_torch"],
                    help="registry modules (default: the package registry)")
    ap.add_argument("--lock", default=DEFAULT_SCHEMA_PATH, metavar="FILE",
                    help=f"schema lock file (default: {DEFAULT_SCHEMA_PATH})")
    ap.add_argument("--write", action="store_true",
                    help="rewrite the lock from the current schemas (merged over the "
                         "rows of entries not run now) and exit 0")
    ap.add_argument("--diff", action="store_true",
                    help=f"print every leaf change of a drifted entry (default: the "
                         f"first {_DIFF_LIMIT})")
    ap.add_argument("--vmap", action="store_true",
                    help="also run each entry under torch.func.vmap over a member axis "
                         "and report batchability breaks as JXA502 findings")
    ap.add_argument("--members", type=int, default=2, metavar="M",
                    help="member-axis width for --vmap (default: 2)")
    ap.add_argument("--entries", metavar="NAMES",
                    help="comma-separated entry names (default: all; stale lock rows "
                         "are only reported on whole-registry runs)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable payload instead of the text report")
    ap.add_argument("--cpu", action="store_true",
                    help="run the entries on the CPU (the kernels' plain versions)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    prog = "sphexa-torch-audit schema"
    from sphexa_torch.devtools.audit.cli import audit_device, load_entries
    from sphexa_torch.devtools.audit.core import (
        Auditor,
        EntrySkip,
        audit_context,
        entry_trace,
        run_sharded,
        set_audit_context,
    )

    device = audit_device(prog, args.cpu)
    if device is None:
        return 2
    members = max(args.members, 1)
    prev = set_audit_context(dataclasses.replace(
        audit_context(), device=device, state_schema_path=args.lock,
        vmap_members=members if args.vmap else 0))
    try:
        try:
            entries = load_entries(args.targets, args.entries)
        except (ImportError, OSError, SyntaxError, ValueError) as e:
            print(f"{prog}: {e}", file=sys.stderr)
            return 2
        locked: Dict[str, Dict[str, Any]] = {}
        if not args.write or Path(args.lock).exists():
            try:
                locked = load_lock(args.lock)
            except LockError as e:
                print(f"{prog}: {e}", file=sys.stderr)
                return 2
        # the carry closure (and under --vmap the batchability) run on the
        # same traces as the rows; JXA501 itself is the comparison below
        auditor = Auditor(select=["JXA503"] + (["JXA502"] if args.vmap else []))
        current: Dict[str, Dict[str, Any]] = {}
        findings: List[Any] = []
        vmap_reports: Dict[str, Any] = {}
        errors: List[str] = []
        skipped: List[str] = []
        run_sharded(entries)
        for entry in entries:
            try:
                trace = entry_trace(entry)
                current[entry.name] = entry_schema(trace)
            except EntrySkip as e:
                skipped.append(f"{entry.name}: {e}")
                continue
            except Exception as e:  # noqa: BLE001 - reported, exit 1
                errors.append(f"{entry.name}: {e.__class__.__name__}: {e}")
                continue
            for rule in auditor.rules.values():
                try:
                    for view in (trace.ranks if trace.sharded else [trace]):
                        findings += [f for f in rule.check(view) if f not in findings]
                except Exception as e:  # noqa: BLE001 - reported, exit 1
                    errors.append(f"{entry.name}: {rule.id} crashed: "
                                  f"{e.__class__.__name__}: {e}")
            if args.vmap and not entry.mesh_axes:
                vmap_reports[entry.name] = vmap_probe(trace, members)

        if args.write:
            merged = dict(locked)
            merged.update(current)
            write_lock(args.lock, merged)
            print(f"{prog}: wrote {len(current)} schema row(s) to {args.lock} "
                  f"({len(merged)} total)")
            for err in errors:
                print(f"entry error: {err}", file=sys.stderr)
            return 1 if errors else 0

        mismatched, missing, report, payload = [], [], [], []
        for name, row in current.items():
            lrow = locked.get(name)
            if lrow is None:
                missing.append(name)
                payload.append({"entry": name, "match": False, "locked": False,
                                "deltas": None})
                continue
            match = lrow == row
            payload.append({"entry": name, "match": match, "locked": True,
                            "leaves": (len(row.get("leaves", {})) if "ranks" not in row else
                                       [len(r.get("leaves", {})) for r in row["ranks"]]),
                            "deltas": None if match else _delta_summary(lrow, row)})
            if not match:
                mismatched.append(name)
                report += row_diff(name, lrow, row, verbose=args.diff)
        stale = []
        if not args.entries:
            audited = set(current) | {s.split(":", 1)[0] for s in skipped}
            stale = sorted(set(locked) - audited)
        bad = bool(mismatched or missing or stale or errors or findings)
        if args.json:
            print(json.dumps({"tool": "statecheck", "lock": str(args.lock), "device": device,
                              "entries": payload, "mismatched": sorted(mismatched),
                              "missing_from_lock": sorted(missing), "stale_lock_rows": stale,
                              "findings": [f.to_json() for f in findings],
                              "vmap": vmap_reports, "errors": errors, "skipped": skipped},
                             indent=2, sort_keys=True))
            return 1 if bad else 0
        for note in skipped:
            print(f"{prog}: skipped {note}", file=sys.stderr)
        for line in report:
            print(line)
        for name in missing:
            print(f"entry {name}: not in the schema lock (re-lock with --write)")
        for name in stale:
            print(f"lock row {name}: no such registry entry (stale: re-lock with --write)")
        for f in findings:
            print(f.format())
        for err in errors:
            print(f"entry error: {err}", file=sys.stderr)
        if args.vmap:
            clean = sorted(n for n, r in vmap_reports.items()
                           if not r["error"] and not r["launches"])
            print(f"vmap report: {len(clean)}/{len(vmap_reports)} entries batch clean over "
                  f"{members} members")
        ok = len(current) - len(mismatched) - len(missing)
        print(f"{prog}: {ok}/{len(current)} entries match {args.lock} on {device}"
              + (f"; {len(mismatched)} drifted" if mismatched else "")
              + (f"; {len(missing)} unlocked" if missing else "")
              + (f"; {len(stale)} stale" if stale else "")
              + (f"; {len(findings)} finding(s)" if findings else "")
              + (f"; {len(errors)} errors" if errors else ""))
        return 1 if bad else 0
    finally:
        set_audit_context(prev)


if __name__ == "__main__":
    sys.exit(main())
