"""The lowering lock of the port (the JAX package's devtools/audit/
lowerdiff.py, jaxdiff): canonical fingerprints of what each entry runs,
the committed ``LOWERING_LOCK_TORCH.json``, and the structural differ.

    python -m sphexa_torch.devtools.audit lowering [targets] [--lock F]
        [--diff] [--write] [--entries ...] [--json] [--cpu]

A torch step has no jaxpr; its counterpart is the record of one run
(tally.py ``Tally.rows``: one canonical row per op the tally charges, one
``kernel:<name>`` token per launch, one row per host boundary; operands
and results by dtype, shape and first-seen number, so the rows are
alpha-stable: two runs of the same program give the same rows). Each
entry's record is digested into a ``LoweringFingerprint``: one whole-run
digest, one per-row hash stream (so a diff names the first row that
differs), per-phase sub-digests keyed by the ``sphexa/<phase>`` taxonomy
and the run-length ``phase_runs`` map, the constants (JXA105's captured
device tensors: their bytes and a digest of their shapes and dtypes), the
collectives, and the ``launches`` map (kernel name -> launches a run),
where PERF.md's launch contract is checked: K12 once and K13 once a
gravity solve, each list-mode walk once and K1 never. The fingerprints of
the registry live in the committed lock; a mismatch exits 1 with a
structural diff (first differing row, rows added or removed per phase,
launch deltas) and an intended change is re-locked with ``--write``.

A sharded entry locks one fingerprint a rank (``{"mesh": P, "ranks":
[...]}``, at P = 2), each with its collectives counted in ``collectives``.

The card's record equals the CPU's (chip_smoke.py's ``audit_path`` holds
it), so the lock is written on the CPU and gates both.

The same fingerprints carry the JXA402 knob-inertness probes
(``production_knob_probes``): for every tuning knob with an off sentinel
a probe ``Simulation(tuned={knob: off})``'s step must fingerprint as the
step that never names the knob.
"""

import argparse
import collections
import dataclasses
import hashlib
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "LOCK_VERSION",
    "DEFAULT_LOCK_PATH",
    "LockError",
    "PhaseFingerprint",
    "LoweringFingerprint",
    "fingerprint_tally",
    "lowering_fingerprint",
    "rank_fingerprints",
    "lock_row",
    "rank_rows",
    "row_matches",
    "load_lock",
    "write_lock",
    "structural_diff",
    "KnobProbe",
    "production_knob_probes",
    "main",
]

LOCK_VERSION = 1
DEFAULT_LOCK_PATH = "LOWERING_LOCK_TORCH.json"

#: hex chars per row hash in the lock's row streams
_HASH_W = 8


def _sha(data: str) -> str:
    return hashlib.sha256(data.encode()).hexdigest()


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhaseFingerprint:
    digest: str
    eqns: int
    eqn_hashes: str      # _HASH_W hex chars per row, record order


@dataclasses.dataclass(frozen=True)
class LoweringFingerprint:
    digest: str          # whole run: rows + constants
    eqns: int            # rows
    collectives: int
    const_bytes: int
    consts_digest: str
    phases: Dict[str, PhaseFingerprint]
    eqn_hashes: str      # global per-row hash stream, record order
    launches: Dict[str, int]
    # in memory only (not in the lock): the rows and their phases, for the
    # structural diff's first-divergence text
    lines: Tuple[str, ...] = dataclasses.field(default=(), repr=False)
    line_phases: Tuple[str, ...] = dataclasses.field(default=(), repr=False)

    def lock_payload(self) -> Dict[str, Any]:
        # the per-phase hash streams are not stored: they rebuild from the
        # global stream and the run-length phase map
        runs: List[List[Any]] = []
        for ph in self.line_phases:
            if runs and runs[-1][0] == ph:
                runs[-1][1] += 1
            else:
                runs.append([ph, 1])
        return {
            "digest": self.digest,
            "eqns": self.eqns,
            "collectives": self.collectives,
            "const_bytes": self.const_bytes,
            "consts_digest": self.consts_digest,
            "eqn_hashes": self.eqn_hashes,
            "phase_runs": runs,
            "phases": {name: {"digest": p.digest, "eqns": p.eqns}
                       for name, p in sorted(self.phases.items())},
            "launches": dict(sorted(self.launches.items())),
        }


def fingerprint_tally(tally) -> LoweringFingerprint:
    """Digest one tallied run's record."""
    rows = tally.rows
    lines = [r.text for r in rows]
    line_phases = [r.phase for r in rows]
    hashes = [_sha(ln)[:_HASH_W] for ln in lines]
    consts = "\n".join(f"{dt}{list(shape)}:{nb}" for _, dt, shape, nb in tally.captured)
    consts_digest = _sha(consts)[:32]
    by_phase: Dict[str, List[str]] = collections.defaultdict(list)
    by_phase_h: Dict[str, List[str]] = collections.defaultdict(list)
    for ln, ph, h in zip(lines, line_phases, hashes):
        by_phase[ph].append(ln)
        by_phase_h[ph].append(h)
    phases = {ph: PhaseFingerprint(digest=_sha("\n".join(lns))[:32], eqns=len(lns),
                                   eqn_hashes="".join(by_phase_h[ph]))
              for ph, lns in by_phase.items()}
    return LoweringFingerprint(
        digest=_sha("\n".join(lines) + "\n#" + consts_digest)[:32],
        eqns=len(lines),
        collectives=sum(1 for r in rows if r.line.startswith(("c10d", "_c10d"))),
        const_bytes=sum(nb for *_, nb in tally.captured),
        consts_digest=consts_digest,
        phases=phases,
        eqn_hashes="".join(hashes),
        launches=dict(tally.kernels),
        lines=tuple(lines),
        line_phases=tuple(line_phases),
    )


def lowering_fingerprint(trace) -> LoweringFingerprint:
    """Cached per-entry fingerprint: one recorded run per EntryTrace,
    shared by the lock CLI and the rules (a sharded entry's: rank 0's)."""
    cached = getattr(trace, "_lowering_fp", None)
    if cached is None:
        cached = trace._lowering_fp = fingerprint_tally(trace.tally)
    return cached


def rank_fingerprints(trace) -> List[LoweringFingerprint]:
    """One fingerprint a rank (one on one device)."""
    return [lowering_fingerprint(v) for v in trace.ranks]


def lock_row(trace) -> Dict[str, Any]:
    """The entry's row of the lock: its fingerprint's payload, or a sharded
    entry's {"mesh": P, "ranks": [each rank's payload]}."""
    fps = rank_fingerprints(trace)
    if not trace.sharded:
        return fps[0].lock_payload()
    return {"mesh": len(fps), "ranks": [fp.lock_payload() for fp in fps]}


def rank_rows(row: Dict[str, Any]) -> List[Dict[str, Any]]:
    """A lock row's per-rank payloads (a one-device row is its own)."""
    return row["ranks"] if "ranks" in row else [row]


def row_matches(row: Dict[str, Any], fps: List["LoweringFingerprint"]) -> bool:
    """Every rank's locked payload holds (``matches``), at the same mesh."""
    rows = rank_rows(row)
    return len(rows) == len(fps) and all(matches(r, fp) for r, fp in zip(rows, fps))


# ---------------------------------------------------------------------------
# lock IO
# ---------------------------------------------------------------------------


class LockError(ValueError):
    """Unreadable, corrupt or wrong-version lock file (CLI exit 2)."""


def load_lock(path) -> Dict[str, Dict[str, Any]]:
    p = Path(path)
    try:
        payload = json.loads(p.read_text())
    except OSError as e:
        raise LockError(f"cannot read lock {p}: {e}") from e
    except json.JSONDecodeError as e:
        raise LockError(f"corrupt lock {p}: {e}") from e
    if not isinstance(payload, dict) or "entries" not in payload:
        raise LockError(f"corrupt lock {p}: no 'entries' object")
    if payload.get("version") != LOCK_VERSION:
        raise LockError(f"lock {p} has version {payload.get('version')!r}, this tool "
                        f"writes {LOCK_VERSION} (regenerate with --write)")
    return payload["entries"]


def write_lock(path, entries: Dict[str, Dict[str, Any]]) -> None:
    payload = {
        "version": LOCK_VERSION,
        "tool": "torchdiff",
        "comment": "canonical run fingerprints per audit entry; regenerate with: "
                   "python -m sphexa_torch.devtools.audit lowering --cpu --write",
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    Path(path).write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")


# ---------------------------------------------------------------------------
# structural diff
# ---------------------------------------------------------------------------


def _chunks(stream: str) -> List[str]:
    return [stream[i:i + _HASH_W] for i in range(0, len(stream), _HASH_W)]


def _locked_phase_hashes(locked: Dict[str, Any]) -> Dict[str, List[str]]:
    """Per-phase row-hash lists of a locked row, rebuilt from the global
    stream and the run-length phase map."""
    out: Dict[str, List[str]] = collections.defaultdict(list)
    chunks = _chunks(locked.get("eqn_hashes", ""))
    i = 0
    for ph, n in locked.get("phase_runs", []):
        out[ph] += chunks[i:i + int(n)]
        i += int(n)
    return out


def _divergence(locked: Dict[str, Any], fp: LoweringFingerprint) -> Optional[int]:
    old, new = _chunks(locked.get("eqn_hashes", "")), _chunks(fp.eqn_hashes)
    div = next((i for i, (a, b) in enumerate(zip(old, new)) if a != b), None)
    if div is None and len(old) != len(new):
        div = min(len(old), len(new))
    return div


def _launch_deltas(locked: Dict[str, Any], fp: LoweringFingerprint) -> Dict[str, int]:
    old = locked.get("launches", {})
    return {k: fp.launches.get(k, 0) - old.get(k, 0)
            for k in sorted(set(old) | set(fp.launches))
            if fp.launches.get(k, 0) != old.get(k, 0)}


def structural_diff(name: str, locked: Dict[str, Any], fp: LoweringFingerprint,
                    verbose: bool = False) -> List[str]:
    """Human-readable structural diff of one entry against its locked row."""
    out = [f"entry {name}: the run drifted from the lock",
           f"  digest: {locked.get('digest')} -> {fp.digest}"]
    for field in ("eqns", "collectives", "const_bytes"):
        old, new = locked.get(field), getattr(fp, field)
        if old != new:
            delta = f"  ({new - old:+d})" if isinstance(old, int) else ""
            out.append(f"  {'rows' if field == 'eqns' else field}: {old} -> {new}{delta}")
    if locked.get("consts_digest") != fp.consts_digest:
        out.append(f"  consts: {locked.get('consts_digest')} -> {fp.consts_digest}")
    launches = _launch_deltas(locked, fp)
    if launches:
        out.append("  launches: " + ", ".join(
            f"{k} {locked.get('launches', {}).get(k, 0)} -> {fp.launches.get(k, 0)}"
            for k in launches))
    div = _divergence(locked, fp)
    if div is None:
        out.append("  no per-row divergence (constants changed, or the lock digest "
                   "itself was edited)")
    else:
        phase = fp.line_phases[div] if div < len(fp.line_phases) else "(past the end)"
        out.append(f"  first divergence: row #{div} (phase {phase})")
        out.append(f"    now: {fp.lines[div]}" if div < len(fp.lines) else
                   f"    now: <the run ends at row #{len(fp.lines) - 1}; the locked "
                   f"stream continues>")
    locked_phases = locked.get("phases", {})
    locked_hashes = _locked_phase_hashes(locked)
    rows: List[str] = []
    for ph in sorted(set(locked_phases) | set(fp.phases)):
        lp, cp = locked_phases.get(ph), fp.phases.get(ph)
        if lp is None:
            rows.append(f"    + {ph}: added ({cp.eqns} rows)")
        elif cp is None:
            rows.append(f"    - {ph}: removed ({lp.get('eqns')} rows)")
        elif lp.get("digest") != cp.digest:
            old_c = collections.Counter(locked_hashes.get(ph, []))
            new_c = collections.Counter(_chunks(cp.eqn_hashes))
            added, removed = sum((new_c - old_c).values()), sum((old_c - new_c).values())
            note = f"+{added}/-{removed} rows" if added or removed else "reordered"
            rows.append(f"    ~ {ph}: {note} ({lp.get('eqns')} -> {cp.eqns})")
    if rows:
        out.append("  phases:")
        out += rows
    if verbose and div is not None:
        lo, hi = max(0, div - 2), min(len(fp.lines), div + 6)
        out.append(f"  context (current run, rows #{lo}-#{hi - 1}):")
        out += [f"    {i}: {fp.lines[i]}" for i in range(lo, hi)]
    return out


def deltas(locked: Dict[str, Any], fp: LoweringFingerprint) -> Dict[str, Any]:
    """Machine-readable mismatch summary (the --json payload, JXA402)."""
    div = _divergence(locked, fp)
    locked_phases = locked.get("phases", {})
    return {
        "eqns": fp.eqns - int(locked.get("eqns", 0)),
        "collectives": fp.collectives - int(locked.get("collectives", 0)),
        "const_bytes": fp.const_bytes - int(locked.get("const_bytes", 0)),
        "consts_changed": locked.get("consts_digest") != fp.consts_digest,
        "first_divergence": div,
        "first_divergence_phase": (fp.line_phases[div] if div is not None
                                   and div < len(fp.line_phases) else None),
        "phases_added": sorted(set(fp.phases) - set(locked_phases)),
        "phases_removed": sorted(set(locked_phases) - set(fp.phases)),
        "phases_changed": sorted(ph for ph in set(fp.phases) & set(locked_phases)
                                 if locked_phases[ph].get("digest") != fp.phases[ph].digest),
        "launches": _launch_deltas(locked, fp),
    }


def matches(locked: Dict[str, Any], fp: LoweringFingerprint) -> bool:
    """A locked row holds when the digest and the launch map agree."""
    return locked.get("digest") == fp.digest and not _launch_deltas(locked, fp)


# ---------------------------------------------------------------------------
# JXA402 knob-inertness probes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KnobProbe:
    """One off-vs-unset comparison: the knob, its off value, and the two
    fingerprints JXA402 compares."""

    knob: str
    off_value: object
    base: LoweringFingerprint
    off: LoweringFingerprint
    detail: str = ""


def probe_fingerprint(case: str, prop: str, tuned: Dict[str, Any],
                      device: Optional[str] = None) -> LoweringFingerprint:
    """The fingerprint of one step of a fresh ``Simulation(tuned=tuned)``
    (the registry's side), recorded as a registry step entry is."""
    from sphexa_torch.devtools.audit import registry
    from sphexa_torch.devtools.audit.core import EntryPoint, EntryTrace, audit_context
    from sphexa_torch.init import make_initializer
    from sphexa_torch.simulation import Simulation

    device = device or audit_context().device
    state, box, const = make_initializer(case)(registry._SIDE, device=device)
    sim = Simulation(state, box, const, prop=prop, device=device, tuned=tuned)
    step = registry._step_case(sim)
    entry = EntryPoint(name=f"knob-probe:{tuned}", build=lambda: step)
    return lowering_fingerprint(EntryTrace(entry, step))


def knob_probes(specs, base_entries: Dict[str, Any], device: Optional[str] = None
                ) -> List[KnobProbe]:
    """Off-vs-unset probes of ``specs`` (tuning ``KnobSpec``s): a knob of
    GravityConfig probes the N-body step (the std step has no gravity to
    leak into), any other the std step. The base fingerprint is the
    registry entry's (``base_entries``: prop -> its EntryPoint), recorded
    once a process."""
    from sphexa_torch.devtools.audit.core import entry_trace

    probes = []
    for spec in specs:
        prop = "nbody" if spec.owner == "GravityConfig" else "std"
        case = "evrard" if prop == "nbody" else "sedov"
        base = lowering_fingerprint(entry_trace(base_entries[prop], device))
        off = probe_fingerprint(case, prop, {spec.name: spec.off_sentinel}, device)
        probes.append(KnobProbe(
            knob=spec.name, off_value=spec.off_sentinel, base=base, off=off,
            detail=f"prop={prop} tuned={{{spec.name}: {spec.off_sentinel!r}}} vs unset"))
    return probes


_PROBES: Dict[str, List[KnobProbe]] = {}


def production_knob_probes() -> List[KnobProbe]:
    """Off-vs-unset probes for every off-sentinel knob of tuning/knobs.py:
    the JXA402 payload of the ``knob_inertness`` registry entry, run once a
    process and device. It checks the declarations against the Simulation
    first (``validate_off_sentinels``), so that a renamed resolution site
    fails loudly instead of the probe passing vacuously."""
    from sphexa_torch.devtools.audit import registry
    from sphexa_torch.devtools.audit.core import audit_context
    from sphexa_torch.tuning.knobs import off_sentinel_knobs, validate_off_sentinels

    validate_off_sentinels()
    device = audit_context().device
    if device not in _PROBES:
        _PROBES[device] = knob_probes(off_sentinel_knobs(), {"std": registry.step_std,
                                                             "nbody": registry.step_nbody})
    return _PROBES[device]


# ---------------------------------------------------------------------------
# CLI: lowering
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sphexa-torch-audit lowering",
        description="verify every registered entry's run fingerprint against the "
                    "committed LOWERING_LOCK_TORCH.json; a mismatch exits 1 with a "
                    "phase-attributed structural diff. Re-lock an intended change "
                    "with --write.",
    )
    ap.add_argument("targets", nargs="*", default=["sphexa_torch"],
                    help="registry modules (default: the package registry)")
    ap.add_argument("--lock", default=DEFAULT_LOCK_PATH, metavar="FILE",
                    help=f"lock file (default: {DEFAULT_LOCK_PATH})")
    ap.add_argument("--write", action="store_true",
                    help="rewrite the lock from the current fingerprints (merged over "
                         "the rows of entries not run now) and exit 0")
    ap.add_argument("--diff", action="store_true",
                    help="print the rows around the first divergence of each "
                         "mismatching entry")
    ap.add_argument("--entries", metavar="NAMES",
                    help="comma-separated entry names (default: all; stale lock rows "
                         "are only reported on whole-registry runs)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable payload instead of the text report")
    ap.add_argument("--cpu", action="store_true",
                    help="run the entries on the CPU (the kernels' plain versions; the "
                         "same record as the card's)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    prog = "sphexa-torch-audit lowering"
    from sphexa_torch.devtools.audit.cli import audit_device, load_entries
    from sphexa_torch.devtools.audit.core import (
        EntrySkip,
        audit_context,
        entry_trace,
        run_sharded,
        set_audit_context,
    )

    device = audit_device(prog, args.cpu)
    if device is None:
        return 2
    prev = set_audit_context(dataclasses.replace(audit_context(), device=device))
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

        current: Dict[str, List[LoweringFingerprint]] = {}
        traces: Dict[str, Any] = {}
        errors: List[str] = []
        skipped: List[str] = []
        run_sharded(entries)
        for entry in entries:
            try:
                traces[entry.name] = trace = entry_trace(entry)
                current[entry.name] = rank_fingerprints(trace)
            except EntrySkip as e:
                skipped.append(f"{entry.name}: {e}")
            except Exception as e:  # noqa: BLE001 - reported, exit 1
                errors.append(f"{entry.name}: {e.__class__.__name__}: {e}")

        if args.write:
            merged = dict(locked)
            merged.update({name: lock_row(traces[name]) for name in current})
            write_lock(args.lock, merged)
            print(f"{prog}: wrote {len(current)} fingerprint(s) to {args.lock} "
                  f"({len(merged)} total)")
            for err in errors:
                print(f"entry error: {err}", file=sys.stderr)
            return 1 if errors else 0

        mismatched, missing, report, payload = [], [], [], []
        for name, fps in current.items():
            fp = fps[0]
            row = locked.get(name)
            ranks = {"ranks": [{"digest": f.digest, "eqns": f.eqns,
                                "collectives": f.collectives} for f in fps]} \
                if len(fps) > 1 else {}
            if row is None:
                missing.append(name)
                payload.append({"entry": name, "digest": fp.digest, "locked_digest": None,
                                "match": False, "eqns": fp.eqns, "launches": fp.launches,
                                "deltas": None, **ranks})
                continue
            lrows = rank_rows(row)
            match = row_matches(row, fps)
            payload.append({"entry": name, "digest": fp.digest,
                            "locked_digest": lrows[0].get("digest"), "match": match,
                            "eqns": fp.eqns, "collectives": fp.collectives,
                            "const_bytes": fp.const_bytes, "launches": fp.launches,
                            "deltas": None if match else [deltas(lr, f) for lr, f in
                                                          zip(lrows, fps)], **ranks})
            if not match:
                mismatched.append(name)
                if len(lrows) != len(fps):
                    report.append(f"entry {name}: locked at {len(lrows)} rank(s), recorded "
                                  f"at {len(fps)}")
                for r, (lr, f) in enumerate(zip(lrows, fps)):
                    if not matches(lr, f):
                        label = name if len(fps) == 1 else f"{name}[rank {r}]"
                        report += structural_diff(label, lr, f, verbose=args.diff)
        stale = []
        if not args.entries:
            audited = set(current) | {s.split(":", 1)[0] for s in skipped}
            stale = sorted(set(locked) - audited)
        bad = bool(mismatched or missing or stale or errors)
        if args.json:
            print(json.dumps({"tool": "torchdiff", "lock": str(args.lock), "device": device,
                              "entries": payload, "mismatched": sorted(mismatched),
                              "missing_from_lock": sorted(missing),
                              "stale_lock_rows": stale, "errors": errors,
                              "skipped": skipped}, indent=2, sort_keys=True))
            return 1 if bad else 0
        for note in skipped:
            print(f"{prog}: skipped {note}", file=sys.stderr)
        for line in report:
            print(line)
        for name in missing:
            print(f"entry {name}: not in the lock (re-lock with --write)")
        for name in stale:
            print(f"lock row {name}: no such registry entry (stale: re-lock with --write)")
        for err in errors:
            print(f"entry error: {err}", file=sys.stderr)
        ok = len(current) - len(mismatched) - len(missing)
        print(f"{prog}: {ok}/{len(current)} entries match {args.lock} on {device}"
              + (f"; {len(mismatched)} mismatched" if mismatched else "")
              + (f"; {len(missing)} unlocked" if missing else "")
              + (f"; {len(stale)} stale" if stale else "")
              + (f"; {len(errors)} errors" if errors else ""))
        return 1 if bad else 0
    finally:
        set_audit_context(prev)


if __name__ == "__main__":
    sys.exit(main())
