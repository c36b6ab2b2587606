"""``serve`` / ``fleet`` of the port's telemetry reader (sphexa_tpu/
telemetry/serve.py): the dashboard over the port's run dirs.

    python -m sphexa_torch.telemetry serve <dir|glob> [--out HTML] [--port N]
                                           [--refresh S] [--once]
    python -m sphexa_torch.telemetry fleet <glob> [--format text|json]

Tails ``events.jsonl`` across one or many run directories (a glob = a
fleet) and writes one self-contained, auto-refreshing HTML page: per-run
step-time sparklines, energy drift and watchdog status, per-rank load and
imbalance, dt_bins histograms, tuning provenance, crash blackboxes in
red, and the latest field frame of the ``snapshots/`` .npz ring
(observables/snapshot.py) through ``viz.render_grid`` / ``viz._png_bytes``
(base64-inlined: the page has no external assets). numpy and the
standard library only (``http.server`` for ``--port``); no device. Exit
codes: 0 rendered, 1 no run directory matched, 2 every matched run
unreadable.

``fleet`` is the text table over the same discovery: one row per run with
its step count, p50 step time, drift, frames and crash state.
"""

import base64
import glob as _glob
import html as _html
import json
import os
import sys
import time
import zipfile
from typing import Dict, List, Optional

import numpy as np

from sphexa_torch.telemetry.cli import (
    TelemetryError,
    _of_kind,
    load_events,
    summarize_run,
    summarize_science,
    summarize_shards,
    summarize_tuning_run,
)
from sphexa_torch.telemetry.tables import render_table

# ---------------------------------------------------------------------------
# discovery
# ---------------------------------------------------------------------------


def _is_run_dir(path: str) -> bool:
    return os.path.isdir(path) \
        and os.path.exists(os.path.join(path, "events.jsonl"))


def discover_runs(target: str) -> List[str]:
    """Run directories for one CLI target: a run dir itself, a fleet
    root (direct children that are run dirs), or a glob over either.
    Sorted for stable rendering; a live fleet's members keep their slots
    across refreshes."""
    candidates: List[str] = []
    if os.path.isdir(target):
        if _is_run_dir(target):
            candidates = [target]
        else:
            candidates = [os.path.join(target, d)
                          for d in sorted(os.listdir(target))]
    else:
        candidates = sorted(_glob.glob(target))
    return [c for c in candidates if _is_run_dir(c)]


# ---------------------------------------------------------------------------
# per-run card
# ---------------------------------------------------------------------------


def _latest_frame(run_dir: str, events: List[dict]) -> Optional[str]:
    """Path of the newest snapshot .npz frame: the last ``snapshot``
    event's path when it still exists (the ring prunes), else the
    newest file in ``<run_dir>/snapshots/`` (a copied/committed run's
    events may carry absolute paths from another machine)."""
    for e in reversed(_of_kind(events, "snapshot")):
        p = e.get("path")
        if isinstance(p, str):
            if os.path.exists(p):
                return p
            local = os.path.join(run_dir, "snapshots", os.path.basename(p))
            if os.path.exists(local):
                return local
    ring = sorted(_glob.glob(os.path.join(run_dir, "snapshots", "*.npz")))
    return ring[-1] if ring else None


def _frame_png(path: str) -> Optional[Dict]:
    """Render one .npz ring frame to PNG bytes + meta (None when the
    file is unreadable — a racing ring prune must not kill the page)."""
    from sphexa_torch.viz import _png_bytes, render_grid

    try:
        with np.load(path, allow_pickle=False) as z:
            grid = np.asarray(z["grid"], np.float64)
            fields = [str(f) for f in z["fields"]] if "fields" in z else []
            it = int(z["it"]) if "it" in z else None
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None
    if grid.ndim == 4:          # volume frame: render the axis-2 sum
        grid = grid.sum(axis=-1)
    if grid.ndim != 3 or grid.shape[-1] < 2:
        return None
    upsample = max(1, 192 // grid.shape[-1])
    png = _png_bytes(render_grid(grid[0], upsample=upsample))
    return {"png": png, "field": fields[0] if fields else "?", "it": it,
            "path": path}


def build_run_card(run_dir: str) -> Dict:
    """Everything the dashboard shows for one run, reusing the CLI
    summarizers. Unreadable runs degrade to an ``error`` card (rendered
    red) instead of taking the fleet page down."""
    try:
        events, _problems = load_events(run_dir)
        summary = summarize_run(run_dir)
        science = summarize_science(run_dir)
        shards = summarize_shards(run_dir)
        tuning = summarize_tuning_run(run_dir)
    except TelemetryError as e:
        return {"run_dir": run_dir, "name": os.path.basename(
            os.path.normpath(run_dir)), "error": str(e)}
    if not events and summary["schema_problems"]:
        # a file of unparseable lines is corruption, not an idle run
        return {"run_dir": run_dir, "name": os.path.basename(
            os.path.normpath(run_dir)),
            "error": "corrupt events.jsonl: "
                     + "; ".join(summary["schema_problems"][:3])}

    # step-time series for the sparkline (same unification as
    # summarize_run: checked steps + deferred windows' per-step means)
    samples: List[float] = []
    for e in _of_kind(events, "step"):
        if isinstance(e.get("wall_s"), (int, float)):
            samples.append(float(e["wall_s"]))
    for e in _of_kind(events, "window"):
        if isinstance(e.get("per_step_s"), (int, float)) \
                and isinstance(e.get("steps"), int):
            samples.extend([float(e["per_step_s"])] * e["steps"])

    # drift series (per-step etot excursion) for the drift sparkline
    etot = []
    for e in _of_kind(events, "physics"):
        v = e.get("etot")
        etot.extend(float(x) for x in (v if isinstance(v, list) else [v])
                    if isinstance(x, (int, float)))

    snap_events = _of_kind(events, "snapshot")
    frame_path = _latest_frame(run_dir, events)
    return {
        "run_dir": run_dir,
        "name": os.path.basename(os.path.normpath(run_dir)),
        "summary": summary,
        "science": science,
        "shards": shards,
        "tuning": tuning,
        "step_series": samples,
        "etot_series": etot,
        "snapshots": len(snap_events),
        "last_snapshot": snap_events[-1] if snap_events else None,
        "frame": _frame_png(frame_path) if frame_path else None,
        "watchdogs": {
            "drift": science["drift_events"],
            "field_health": science["field_health_events"],
            "imbalance": summary["imbalances"],
        },
        "crash": summary["crash"],
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

_CSS = """
body { background:#111418; color:#d8dee9; font-family:monospace;
       margin:1.2em; }
h1 { font-size:1.2em; } h2 { font-size:1.0em; margin:0.2em 0; }
.card { border:1px solid #2e3440; border-radius:6px; padding:0.8em;
        margin:0.8em 0; background:#161a20; }
.card.crash { border-color:#bf3f3f; background:#200909; }
.badge { display:inline-block; padding:0 0.5em; border-radius:3px;
         margin-right:0.4em; }
.ok { background:#1d3321; color:#a3be8c; }
.bad { background:#3b1113; color:#e06c75; }
.warn { background:#332b16; color:#ebcb8b; }
.crashbox { color:#e06c75; white-space:pre-wrap; }
table { border-collapse:collapse; } td, th { padding:0 0.7em 0 0;
        text-align:left; }
.grid { image-rendering:pixelated; border:1px solid #2e3440; }
svg { background:#0d1014; border:1px solid #2e3440; }
.muted { color:#6b7480; }
"""


def _sparkline(values: List[float], width: int = 220, height: int = 36,
               color: str = "#88c0d0") -> str:
    """Inline SVG polyline of one series (empty series -> empty box)."""
    vals = [v for v in values if np.isfinite(v)]
    if len(vals) < 2:
        return (f'<svg width="{width}" height="{height}">'
                f'<text x="4" y="{height - 6}" fill="#6b7480" '
                f'font-size="10">no data</text></svg>')
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    pts = " ".join(
        f"{i * (width - 4) / (len(vals) - 1) + 2:.1f},"
        f"{height - 3 - (v - lo) / span * (height - 6):.1f}"
        for i, v in enumerate(vals))
    return (f'<svg width="{width}" height="{height}">'
            f'<polyline points="{pts}" fill="none" stroke="{color}" '
            f'stroke-width="1.2"/></svg>')


def _bars(pop: List[int], width: int = 160, height: int = 36,
          color: str = "#b48ead") -> str:
    """Inline SVG histogram (the dt_bins bin-occupancy view)."""
    if not pop:
        return ""
    peak = max(max(pop), 1)
    n = len(pop)
    bw = max(2.0, (width - 4) / n - 2)
    bars = "".join(
        f'<rect x="{2 + i * (width - 4) / n:.1f}" '
        f'y="{height - 2 - (v / peak) * (height - 6):.1f}" '
        f'width="{bw:.1f}" '
        f'height="{max(0.5, (v / peak) * (height - 6)):.1f}" '
        f'fill="{color}"/>'
        for i, v in enumerate(pop))
    return f'<svg width="{width}" height="{height}">{bars}</svg>'


def _esc(v) -> str:
    return _html.escape(str(v))


def _fmt_s(v: Optional[float]) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    return f"{v * 1e3:.1f}ms" if v < 1.0 else f"{v:.2f}s"


def _card_html(card: Dict) -> str:
    name = _esc(card["name"])
    if card.get("error"):
        return (f'<div class="card crash"><h2>{name}</h2>'
                f'<div class="crashbox">UNREADABLE: '
                f'{_esc(card["error"])}</div></div>')
    s = card["summary"]
    sci = card["science"]
    sh = card["shards"]
    crash = card["crash"]
    cls = "card crash" if crash else "card"
    bits = [f'<div class="{cls}" id="{name}"><h2>{name}</h2>']

    # status badges: crash > watchdogs > clean
    wd = card["watchdogs"]
    if crash:
        bits.append('<span class="badge bad">CRASHED</span>')
    for key, n in wd.items():
        klass = "bad" if n else "ok"
        bits.append(f'<span class="badge {klass}">{key}: {n}</span>')
    drift = (sci.get("drift") or {}).get("max")
    if drift is not None:
        klass = "warn" if drift > 1e-3 else "ok"
        bits.append(
            f'<span class="badge {klass}">drift {drift:.2e}</span>')

    # headline numbers
    st = s.get("step_time") or {}
    bits.append("<table><tr>"
                f"<td>steps {s['steps']}</td>"
                f"<td>p50 {_fmt_s(st.get('p50_s'))}</td>"
                f"<td>p95 {_fmt_s(st.get('p95_s'))}</td>"
                f"<td>retraces {s['retraces']}</td>"
                f"<td>rollbacks {s['rollbacks']}</td>"
                f"<td>reconfigures {s['reconfigures']}</td>"
                "</tr></table>")

    # sparklines: step time + total energy
    bits.append("<table><tr><th>step time</th><th>etot</th></tr><tr>"
                f"<td>{_sparkline(card['step_series'])}</td>"
                f"<td>{_sparkline(card['etot_series'], color='#a3be8c')}"
                "</td></tr></table>")

    # per-shard load/imbalance
    if sh.get("shards"):
        rows = []
        for row in sh["shards"]:
            share = row.get("work_share")
            occ = row.get("occ_p95")
            rows.append(
                f"<tr><td>{row['shard']}</td>"
                f"<td>{row.get('particles') or '-'}</td>"
                f"<td>{'-' if share is None else f'{share:.1%}'}</td>"
                f"<td>{'-' if occ is None else f'{occ:.2f}'}</td></tr>")
        bits.append(
            "<details open><summary>shards "
            f"(imbalance events: {s['imbalances']})</summary>"
            "<table><tr><th>shard</th><th>particles</th>"
            "<th>work share</th><th>occ p95</th></tr>"
            + "".join(rows) + "</table></details>")

    # dt_bins histogram
    bins = sci.get("dt_bins")
    if bins:
        saved = bins.get("saved_factor")
        bits.append(
            "<details open><summary>dt_bins "
            f"(saved {'-' if saved is None else f'{saved:.1f}x'})"
            f"</summary>{_bars(bins.get('pop') or [])}</details>")

    # tuning provenance
    stamp = card["tuning"].get("manifest_tuning")
    if stamp:
        knobs = ", ".join(f"{k}={v}" for k, v in
                          sorted((stamp.get("knobs") or {}).items()))
        bits.append(f'<div class="muted">tuning: '
                    f'{_esc(stamp.get("source"))} {_esc(knobs)}</div>')

    # latest field frame from the snapshot ring
    frame = card.get("frame")
    if frame:
        b64 = base64.b64encode(frame["png"]).decode("ascii")
        bits.append(
            f'<div>field <b>{_esc(frame["field"])}</b> @ it '
            f'{frame["it"]} <span class="muted">'
            f'({card["snapshots"]} snapshot events)</span><br>'
            f'<img class="grid" src="data:image/png;base64,{b64}" '
            f'alt="field frame"/></div>')
    elif card["snapshots"]:
        bits.append(f'<div class="muted">{card["snapshots"]} snapshot '
                    f'events, no readable .npz frame</div>')

    # crash blackbox, rendered red
    if crash:
        tail = "\n".join(crash.get("traceback_tail") or [])
        wds = ", ".join(f"{k}={v}" for k, v in
                        (crash.get("watchdogs") or {}).items())
        bits.append(
            '<div class="crashbox"><b>CRASH</b>: '
            f'{_esc(crash.get("reason"))}\n'
            f'watchdogs: {_esc(wds or "-")}\n{_esc(tail)}</div>')
    bits.append("</div>")
    return "\n".join(bits)


def render_html(cards: List[Dict], refresh: Optional[float] = None,
                title: str = "sphexa fleet") -> str:
    """The whole dashboard as one self-contained HTML string."""
    meta = (f'<meta http-equiv="refresh" content="{refresh:g}">'
            if refresh else "")
    crashed = sum(1 for c in cards if c.get("crash") or c.get("error"))
    head = (f"<h1>{_esc(title)} — {len(cards)} run"
            f"{'s' if len(cards) != 1 else ''}, {crashed} "
            f"crashed/unreadable <span class='muted'>"
            f"({time.strftime('%Y-%m-%d %H:%M:%S')})</span></h1>")
    body = "\n".join(_card_html(c) for c in cards)
    return (f"<!doctype html><html><head><meta charset='utf-8'>{meta}"
            f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
            f"<body>{head}{body}</body></html>")


# ---------------------------------------------------------------------------
# fleet table
# ---------------------------------------------------------------------------


def fleet_rows(run_dirs: List[str]) -> List[Dict]:
    return [build_run_card(d) for d in run_dirs]


def render_fleet(cards: List[Dict]) -> str:
    rows = []
    for c in cards:
        if c.get("error"):
            rows.append((c["name"], "-", "-", "-", "-", "UNREADABLE"))
            continue
        st = (c["summary"].get("step_time") or {})
        drift = (c["science"].get("drift") or {}).get("max")
        wd = sum(c["watchdogs"].values())
        status = "CRASHED" if c["crash"] else (
            "watchdog" if wd else "ok")
        rows.append((
            c["name"], c["summary"]["steps"], _fmt_s(st.get("p50_s")),
            "-" if drift is None else f"{drift:.2e}",
            c["snapshots"], status,
        ))
    return render_table(
        rows, headers=("run", "steps", "p50", "drift", "frames",
                       "status"))


# ---------------------------------------------------------------------------
# CLI entry points (wired from telemetry/cli.py)
# ---------------------------------------------------------------------------


def serve_cmd(target: str, out: Optional[str] = None,
              port: Optional[int] = None, refresh: float = 5.0,
              once: bool = False) -> int:
    """The ``serve`` subcommand. ``--once`` renders a single page and
    exits (the CI shape); ``--port`` serves it via http.server,
    regenerating per request; the default loop rewrites ``--out`` every
    ``--refresh`` seconds until interrupted."""
    runs = discover_runs(target)
    if not runs:
        print(f"sphexa-torch-telemetry serve: no run directories match "
              f"{target!r}", file=sys.stderr)
        return 1

    def render() -> str:
        cards = fleet_rows(discover_runs(target) or runs)
        return render_html(cards, refresh=None if once else refresh,
                           title=f"sphexa fleet: {target}")

    page = render()
    cards_now = fleet_rows(runs)
    if all(c.get("error") for c in cards_now):
        for c in cards_now:
            print(f"sphexa-torch-telemetry serve: {c['run_dir']}: "
                  f"{c['error']}", file=sys.stderr)
        return 2

    out = out or "sphexa-dashboard.html"
    if port is not None:
        import http.server

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):      # noqa: N802 (stdlib API name)
                body = render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet: the page IS the log
                pass

        with http.server.ThreadingHTTPServer(("", port), Handler) as srv:
            print(f"serving {len(runs)} run(s) on http://localhost:{port}")
            try:
                srv.serve_forever()
            except KeyboardInterrupt:
                pass
        return 0

    with open(out, "w") as f:
        f.write(page)
    print(f"wrote {out} ({len(runs)} run(s))")
    if once:
        return 0
    try:
        while True:
            time.sleep(max(0.5, refresh))
            with open(out, "w") as f:
                f.write(render())
    except KeyboardInterrupt:
        pass
    return 0


def fleet_cmd(target: str, fmt: str = "text") -> int:
    """The ``fleet`` subcommand: the text aggregation table."""
    runs = discover_runs(target)
    if not runs:
        print(f"sphexa-torch-telemetry fleet: no run directories match "
              f"{target!r}", file=sys.stderr)
        return 1
    cards = fleet_rows(runs)
    if all(c.get("error") for c in cards):
        for c in cards:
            print(f"sphexa-torch-telemetry fleet: {c['run_dir']}: "
                  f"{c['error']}", file=sys.stderr)
        return 2
    if fmt == "json":
        view = []
        for c in cards:
            status = ("UNREADABLE" if c.get("error")
                      else "CRASHED" if c.get("crash")
                      else "watchdog" if sum(c["watchdogs"].values())
                      else "ok")
            view.append({k: c.get(k) for k in
                         ("run_dir", "name", "error", "snapshots",
                          "watchdogs")} | {"status": status})
        print(json.dumps(view, indent=2))
    else:
        print(render_fleet(cards))
    return 0
