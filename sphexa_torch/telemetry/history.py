"""Cross-run history of the port (sphexa_tpu/telemetry/history.py): the
trend over bench JSONs and telemetry run dirs, and the lock-file
regression gate.

- ``load_history`` ingests any mix of bench JSONs (a bench line, or a
  round wrapper whose ``tail`` holds one) and telemetry run directories
  into one row-per-input trend table (``python -m sphexa_torch.telemetry
  history``);
- ``evaluate_lock`` is the gate (``regress --lock``): a lock file pins
  measured metrics (value, relative threshold, direction, the source
  file they were read from) and fails when one is worse than
  ``locked * (1 -/+ threshold)``.

One difference from the JAX module: the repo's committed rounds
(``BENCH_r*`` / ``MULTICHIP_r*``) are the JAX package's TPU measurements,
so ``history`` reads only the inputs its caller names; with none it
exits 2 and asks for them.
"""

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

#: committed round wrappers: BENCH_r05.json -> ("bench", 5)
ROUND_RE = re.compile(r"(BENCH|MULTICHIP)_r(\d+)\.json$")

#: lock-file schema (independent of the event schema; bump on shape
#: change and keep reading older locks)
LOCK_SCHEMA = 1


class HistoryError(Exception):
    """Unreadable/invalid input (CLI exit code 2)."""


# ---------------------------------------------------------------------------
# bench JSON parsing (shared with telemetry/cli.py's diff)
# ---------------------------------------------------------------------------


def parse_bench_json(path: str) -> Dict:
    """bench.py's JSON line, or a round wrapper (``BENCH_r*.json`` /
    ``MULTICHIP_r*.json``) whose ``tail`` buries a metric/value line in
    captured output (measure_multichip.py --json emits the same shape,
    so multi-chip comm-volume rounds parse exactly like bench rounds)."""
    with open(path) as f:
        data = json.load(f)
    if "metric" in data and "value" in data:
        return data
    if "tail" in data:
        for line in reversed(str(data["tail"]).splitlines()):
            line = line.strip()
            if line.startswith("{"):
                try:
                    inner = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "metric" in inner and "value" in inner:
                    return inner
    raise HistoryError(f"{path}: not a bench JSON (no metric/value line)")


def field_of(bench: Dict, field: str):
    """Dotted-path lookup into a parsed bench line (``value``,
    ``extra.ve_updates_per_sec``, ``extra.telemetry.retraces``, ...);
    None when any segment is missing or non-numeric."""
    cur = bench
    for seg in field.split("."):
        if not isinstance(cur, dict) or seg not in cur:
            return None
        cur = cur[seg]
    return cur if isinstance(cur, (int, float)) else None


# ---------------------------------------------------------------------------
# trend ingestion
# ---------------------------------------------------------------------------


def _row_from_bench(path: str) -> Dict:
    m = ROUND_RE.search(os.path.basename(path))
    try:
        bench = parse_bench_json(path)
    except HistoryError:
        # a committed wrapper WITHOUT a metric line is a real round that
        # measured nothing (the chip-less MULTICHIP dry runs stamp rc/ok
        # only) — the trend keeps the row, value-less, instead of
        # refusing the whole history. ONLY round-named files or files
        # carrying the round-wrapper shape qualify: an arbitrary JSON
        # (a manifest, the lock file, a typo'd path) must raise (exit
        # 2), not fabricate a row
        with open(path) as f:
            wrapper = json.load(f)  # unreadable JSON still raises (exit 2)
        if not isinstance(wrapper, dict) or (
                m is None and "rc" not in wrapper and "ok" not in wrapper):
            raise
        return {
            "label": os.path.basename(path),
            "kind": m.group(1).lower() if m else "bench",
            "round": int(m.group(2)) if m else None,
            "metric": None, "value": None, "unit": None,
            "vs_baseline": None, "git_rev": None, "backend": None,
            "note": ("dry-run ok" if wrapper.get("ok")
                     else "no measurement"),
        }
    kind = bench_kind(path, bench)
    manifest = bench.get("manifest") or {}
    extra = bench.get("extra") or {}
    row = {
        "label": os.path.basename(path),
        "kind": kind,
        "round": int(m.group(2)) if m else None,
        "metric": bench.get("metric"),
        "value": bench.get("value"),
        "unit": bench.get("unit"),
        "vs_baseline": bench.get("vs_baseline"),
        "git_rev": manifest.get("git_rev"),
        "backend": manifest.get("backend"),
    }
    for k in ("ve_updates_per_sec", "gravity_1m_updates_per_sec",
              "std_energy_drift"):
        if isinstance(extra.get(k), (int, float)):
            row[k] = extra[k]
    tel = extra.get("telemetry") or {}
    for k in ("retraces", "rollbacks", "halo_trips"):
        if isinstance(tel.get(k), (int, float)):
            row[k] = tel[k]
    return row


def _row_from_run(run_dir: str) -> Dict:
    from sphexa_torch.telemetry.cli import summarize_run

    s = summarize_run(run_dir)
    manifest = s.get("manifest") or {}
    p50 = (s.get("step_time") or {}).get("p50_s")
    n = manifest.get("particles")
    return {
        "label": run_dir,
        "kind": "run",
        "round": None,
        "metric": "run p50 throughput",
        "value": (float(n) / p50) if n and p50 else None,
        "unit": "particles/s",
        "vs_baseline": None,
        "git_rev": manifest.get("git_rev"),
        "backend": manifest.get("backend"),
        "step_p50_s": p50,
        "retraces": s.get("retraces"),
        "rollbacks": s.get("rollbacks"),
    }


def load_history(inputs: Sequence[str]) -> List[Dict]:
    """One trend row per input (bench JSON or telemetry run dir), sorted
    kind-major / round-minor so the two trajectories read as two runs of
    consecutive rows. Unreadable inputs raise (exit 2): a trend over
    silently dropped rounds would claim a history it does not have."""
    rows: List[Dict] = []
    for p in inputs:
        if os.path.isdir(p):
            rows.append(_row_from_run(p))
        elif os.path.isfile(p):
            rows.append(_row_from_bench(p))
        else:
            raise HistoryError(f"{p}: neither a bench JSON nor a run dir")
    order = {"bench": 0, "multichip": 1, "run": 2}
    rows.sort(key=lambda r: (order.get(r["kind"], 3),
                             r["round"] if r["round"] is not None else 1 << 30,
                             r["label"]))
    # per-trajectory deltas: value change vs the previous round of the
    # SAME kind — the trend the eleven loose files never showed
    prev: Dict[str, float] = {}
    for r in rows:
        v = r.get("value")
        if isinstance(v, (int, float)) and r["kind"] in prev and prev[r["kind"]]:
            r["change"] = v / prev[r["kind"]] - 1.0
        if isinstance(v, (int, float)):
            prev[r["kind"]] = v
    return rows


def render_history(rows: List[Dict]) -> str:
    from sphexa_torch.telemetry.tables import render_table

    if not rows:
        return ("no history inputs (expected BENCH_r*.json / "
                "MULTICHIP_r*.json or run dirs)")

    def val(r):
        v = r.get("value")
        if v is None:
            return r.get("note") or "-"
        if r["kind"] == "multichip":
            return f"{v:.3g}x"
        return f"{v / 1e6:.3f} M/s" if v >= 1e5 else f"{v:.4g}/s"

    def fmt(v, f="{:.3g}"):
        return "-" if v is None else f.format(v)

    trows = []
    for r in rows:
        trows.append((
            r["label"],
            r["kind"],
            "-" if r.get("round") is None else f"r{r['round']:02d}",
            val(r),
            "-" if r.get("change") is None else f"{r['change'] * 100:+.1f}%",
            fmt(r.get("vs_baseline"), "{:.4f}"),
            fmt(r.get("ve_updates_per_sec"), "{:.3g}"),
            fmt(r.get("gravity_1m_updates_per_sec"), "{:.3g}"),
            fmt(r.get("std_energy_drift"), "{:.2e}"),
        ))
    table = render_table(
        trows, headers=("source", "kind", "round", "headline", "change",
                        "vs_base", "ve", "grav 1M", "drift"))
    lines = [table]
    bench = [r for r in rows if r["kind"] == "bench"
             and isinstance(r.get("value"), (int, float))]
    if len(bench) >= 2:
        first, last = bench[0]["value"], bench[-1]["value"]
        if first:
            lines.append(
                f"bench trajectory: {first / 1e6:.3f} -> "
                f"{last / 1e6:.3f} M updates/s "
                f"({last / first:.2f}x over {len(bench)} rounds)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the regression lock (CI gate)
# ---------------------------------------------------------------------------


def load_lock(path: str) -> Dict:
    try:
        with open(path) as f:
            lock = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise HistoryError(f"{path}: unreadable lock file ({e})")
    if not isinstance(lock, dict) or not isinstance(
            lock.get("metrics"), list):
        raise HistoryError(f"{path}: lock file needs a 'metrics' list")
    for m in lock["metrics"]:
        for req in ("name", "source", "field", "value"):
            if req not in m:
                raise HistoryError(
                    f"{path}: lock metric {m.get('name', '?')!r} missing "
                    f"{req!r}")
    return lock


def bench_kind(path: str, bench: Optional[Dict] = None) -> str:
    """``bench`` vs ``multichip`` for a bench-JSON file: the committed
    wrapper naming convention when the filename carries it, else the
    metric-name heuristic ``load_history`` uses (measure_multichip's
    headline is the sparse-exchange *saving*)."""
    base = os.path.basename(path or "").upper()
    if base.startswith("MULTICHIP"):
        return "multichip"
    if base.startswith("BENCH"):
        return "bench"
    return ("multichip" if "saving" in str((bench or {}).get("metric", ""))
            else "bench")


def _source_kind(source: str, root: str) -> str:
    """``bench_kind`` for a locked metric's committed source: when the
    filename is inconclusive, parse the source itself so the
    metric-name heuristic sees real content (a saving locked from
    'chip_saving.json' must not classify as bench and get gated
    against a throughput candidate). Unreadable sources fall back to
    the filename verdict — non-candidate mode flags them properly."""
    base = os.path.basename(source or "").upper()
    if base.startswith(("MULTICHIP", "BENCH")):
        return bench_kind(source)
    try:
        return bench_kind(source, parse_bench_json(os.path.join(root, source)))
    except (HistoryError, OSError):
        return bench_kind(source)


def evaluate_lock(lock: Dict, root: str,
                  candidate: Optional[str] = None) -> Dict:
    """Check every locked metric against its committed source (or, with
    ``candidate``, against one fresh bench JSON — the pre-commit gate of
    a new chip measurement). A metric is REGRESSED when its current
    value is worse than ``value * (1 - threshold)`` (higher-is-better;
    flipped otherwise). A missing source/field is a failure too: a gate
    that cannot find its metric must not pass green.

    The lock mixes kinds (bench throughputs + the multichip saving) but
    a candidate file measures exactly one of them, so candidate mode
    gates only the locked metrics whose source is the same kind as the
    candidate — the rest are reported as ``skipped`` (a fresh BENCH run
    says nothing about the multichip saving; comparing a throughput
    field against a saving ratio would be a nonsense verdict either
    way). A candidate matching NO locked metric fails: that gate
    checked nothing."""
    rows: List[Dict] = []
    problems: List[str] = []
    cand = parse_bench_json(candidate) if candidate else None
    cand_kind = bench_kind(candidate, cand) if candidate else None
    for m in lock["metrics"]:
        thr = float(m.get("threshold", 0.05))
        hib = bool(m.get("higher_is_better", True))
        locked = float(m["value"])
        if cand_kind is not None \
                and _source_kind(m["source"], root) != cand_kind:
            rows.append({"name": m["name"], "source": m["source"],
                         "locked": locked, "current": None,
                         "threshold": thr, "regressed": False,
                         "change": None, "skipped": True})
            continue
        src = candidate if candidate else os.path.join(root, m["source"])
        try:
            bench = cand if cand is not None else parse_bench_json(src)
            current = field_of(bench, m["field"])
        except (HistoryError, OSError) as e:
            problems.append(f"{m['name']}: {e}")
            current = None
        if current is None:
            rows.append({"name": m["name"], "source": src,
                         "locked": locked, "current": None,
                         "threshold": thr, "regressed": True,
                         "change": None})
            if not problems or m["name"] not in problems[-1]:
                problems.append(
                    f"{m['name']}: field {m['field']!r} missing in {src}")
            continue
        current = float(current)
        floor = locked * (1.0 - thr)
        ceil = locked * (1.0 + thr)
        regressed = current < floor if hib else current > ceil
        rows.append({
            "name": m["name"], "source": src, "locked": locked,
            "current": current, "threshold": thr,
            "change": (current / locked - 1.0) if locked else None,
            "regressed": bool(regressed),
        })
    if candidate and rows and all(r.get("skipped") for r in rows):
        problems.append(
            f"{candidate}: {cand_kind} candidate matches no locked "
            f"{cand_kind} metric — nothing was gated")
    return {
        "lock_schema": lock.get("schema"),
        "rows": rows,
        "problems": problems,
        "regressed": (any(r["regressed"] for r in rows)
                      or bool(candidate and rows
                              and all(r.get("skipped") for r in rows))),
    }


def write_lock(lock_path: str, lock: Dict, root: str) -> Dict:
    """Re-read every metric's source and overwrite the locked values —
    the harvest-day locking step (measure on chip, commit the round
    file, point the lock's ``source`` at it, then ``regress --lock
    <file> --write``). Refuses when any metric is unreadable."""
    res = evaluate_lock(lock, root)
    if res["problems"]:
        raise HistoryError("cannot write lock: "
                           + "; ".join(res["problems"]))
    by_name = {r["name"]: r for r in res["rows"]}
    for m in lock["metrics"]:
        m["value"] = by_name[m["name"]]["current"]
    lock["schema"] = lock.get("schema", LOCK_SCHEMA)
    with open(lock_path, "w") as f:
        json.dump(lock, f, indent=2)
        f.write("\n")
    return lock


def render_regress(res: Dict) -> str:
    from sphexa_torch.telemetry.tables import render_table

    rows = []
    for r in res["rows"]:
        rows.append((
            r["name"],
            f"{r['locked']:.6g}",
            "-" if r["current"] is None else f"{r['current']:.6g}",
            "-" if r.get("change") is None else f"{r['change'] * 100:+.1f}%",
            f"{r['threshold'] * 100:.0f}%",
            ("skipped" if r.get("skipped")
             else "REGRESSED" if r["regressed"] else "ok"),
        ))
    lines = [render_table(
        rows, headers=("metric", "locked", "current", "change", "budget",
                       ""))]
    for p in res["problems"]:
        lines.append(f"  problem: {p}")
    lines.append("regression vs lock" if res["regressed"]
                 else "all locked metrics hold")
    return "\n".join(lines)
