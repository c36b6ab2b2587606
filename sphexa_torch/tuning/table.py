"""The tuning table of the port (sphexa_tpu/tuning/table.py): measured
knob choices as a committed artifact.

``TUNING_TABLE_TORCH.json`` (repo root) is keyed by (workload class, N
bucket, device count P, backend) and carries, per entry, the knob dict a
sweep found plus its provenance (source run, date, objective, measured
win, the card). It is the port's own table: the JAX package's
``TUNING_TABLE.json`` holds choices measured for its own backends and is
never read here. Resolution precedence at ``Simulation(tuned=...)`` /
``make_propagator_config`` time is *explicit kwarg > table entry >
gravity_tuning/default heuristic*; the chosen entry is stamped into the
run manifest and a ``tuning`` event so that a perf diff can attribute a
change to a knob change.

N buckets are decades (``1e4`` = 1e4 <= N < 1e5). This module imports no
config module: knob names are validated against ``knobs.KNOBS``, the live
configs by the package's import-time ``validate_registry()``.
"""

import json
import math
import os
from typing import Dict, List, Optional, Tuple

from sphexa_torch.tuning.knobs import KNOBS

#: table schema version (independent of the event schema)
TABLE_SCHEMA = 1

#: key fields every entry must carry
KEY_FIELDS = ("workload", "n_bucket", "p", "backend")

#: the workload-class wildcard an entry may use to cover every case
GENERIC_WORKLOAD = "generic"

#: environment override for the committed table location
TABLE_ENV = "SPHEXA_TORCH_TUNING_TABLE"


def default_table_path() -> str:
    """The port's committed table at the repo root,
    ``TUNING_TABLE_TORCH.json``, overridable via
    ``SPHEXA_TORCH_TUNING_TABLE``."""
    env = os.environ.get(TABLE_ENV)
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "TUNING_TABLE_TORCH.json")


def n_bucket(n: int) -> str:
    """Decade bucket of a particle count: ``1e5`` = 1e5 <= n < 1e6."""
    return f"1e{int(math.floor(math.log10(max(int(n), 1))))}"


def entry_key(entry: Dict) -> Tuple:
    return tuple(entry.get(k) for k in KEY_FIELDS)


def load_table(path: Optional[str] = None) -> Dict:
    """Read a table file. Raises ``FileNotFoundError`` when it does not
    exist and ``ValueError`` when it is not a table-shaped JSON object
    — the callers' exit-code contracts depend on telling those apart."""
    path = path or default_table_path()
    with open(path) as f:
        table = json.load(f)
    if not isinstance(table, dict) or "entries" not in table:
        raise ValueError(f"{path}: not a tuning table (no 'entries')")
    return table


def save_table(path: str, table: Dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True, default=str)
        f.write("\n")


def new_table() -> Dict:
    return {"schema": TABLE_SCHEMA, "entries": []}


def validate_table(table: Dict) -> List[str]:
    """Schema problems with one table ([] = valid): version, entry
    shape, duplicate keys, and — the gate's teeth — knob names outside
    the registry (a renamed knob makes the committed entry dead weight
    that would silently stop applying)."""
    problems: List[str] = []
    if not isinstance(table, dict):
        return ["table is not an object"]
    if table.get("schema") != TABLE_SCHEMA:
        problems.append(f"bad table schema {table.get('schema')!r} "
                        f"(expected {TABLE_SCHEMA})")
    entries = table.get("entries")
    if not isinstance(entries, list):
        return problems + ["'entries' is not a list"]
    seen = set()
    for i, e in enumerate(entries):
        tag = f"entry {i}"
        if not isinstance(e, dict):
            problems.append(f"{tag}: not an object")
            continue
        for k in KEY_FIELDS:
            if k not in e:
                problems.append(f"{tag}: missing key field {k!r}")
        key = entry_key(e)
        if key in seen:
            problems.append(f"{tag}: duplicate key {key}")
        seen.add(key)
        knobs = e.get("knobs")
        if not isinstance(knobs, dict) or not knobs:
            problems.append(f"{tag}: missing/empty 'knobs'")
            continue
        for name in knobs:
            if name not in KNOBS:
                problems.append(
                    f"{tag}: stale knob {name!r} (not in the registry "
                    f"— renamed/removed; migrate or drop the entry)")
        if not isinstance(e.get("provenance"), dict):
            problems.append(f"{tag}: missing 'provenance'")
    return problems


def resolve_entry(table: Dict, workload: str, n: int, p: int,
                  backend: str) -> Optional[Dict]:
    """The entry covering (workload, N, P, backend), or None. An exact
    workload match wins over a ``generic`` wildcard entry."""
    want = (str(workload), n_bucket(n), int(p), str(backend))
    fallback = None
    for e in table.get("entries", ()):
        key = entry_key(e)
        if key == want:
            return e
        if key == (GENERIC_WORKLOAD,) + want[1:]:
            fallback = e
    return fallback


def upsert_entry(table: Dict, entry: Dict) -> Dict:
    """Insert/replace the entry with the same key; returns the table."""
    key = entry_key(entry)
    table["entries"] = [e for e in table.get("entries", [])
                        if entry_key(e) != key] + [entry]
    return table


def make_entry(workload: str, n: int, p: int, backend: str,
               knobs: Dict, provenance: Dict) -> Dict:
    bad = sorted(set(knobs) - set(KNOBS))
    if bad:
        raise ValueError(f"unregistered knobs {bad}; add a KnobSpec "
                         f"(sphexa_torch/tuning/knobs.py) first")
    return {"workload": str(workload), "n_bucket": n_bucket(n),
            "p": int(p), "backend": str(backend),
            "knobs": dict(knobs), "provenance": dict(provenance)}


def resolve_knobs(tuned, workload: Optional[str], n: int, p: int,
                  backend: str,
                  explicit: Dict) -> Tuple[Dict, Dict]:
    """The tuned="auto" resolution: (overrides, provenance).

    ``tuned`` is what the caller passed: None (heuristics only),
    ``"auto"`` (the committed table, silently absent-ok), a table path
    (must exist), a loaded table dict, or a plain knob dict (the replay
    harness's per-candidate path — source ``direct``). ``explicit``
    holds the knobs the caller spelled out as kwargs; they are REMOVED
    from the returned overrides, which is the whole precedence rule —
    explicit kwarg > table entry > heuristic/default — enforced in one
    place. ``overrides`` contains only table/direct values the caller
    should apply on top of its defaults; ``provenance`` names the
    winner per knob and is what gets stamped into the run manifest and
    the ``tuning`` event.
    """
    source, entry, path = "heuristic", None, None
    table_knobs: Dict = {}
    if tuned is None:
        pass
    elif isinstance(tuned, dict) and "entries" not in tuned:
        # a raw knob dict: the sweep's candidate path
        bad = sorted(set(tuned) - set(KNOBS))
        if bad:
            raise ValueError(f"tuned= knob dict has unregistered knobs "
                             f"{bad} (see sphexa_torch/tuning/knobs.py)")
        table_knobs, source = dict(tuned), "direct"
    else:
        if isinstance(tuned, dict):
            table = tuned
        else:
            path = default_table_path() if tuned == "auto" else str(tuned)
            if tuned == "auto" and not os.path.exists(path):
                # auto is opportunistic: no committed table, no tuning
                table = new_table()
            else:
                table = load_table(path)
        entry = resolve_entry(table, workload or GENERIC_WORKLOAD,
                              n, p, backend)
        if entry is not None:
            table_knobs, source = dict(entry["knobs"]), "table"
    overrides = {k: v for k, v in table_knobs.items() if k not in explicit}
    if source != "heuristic" and not overrides:
        # the caller's kwargs overrode everything the entry offered (or
        # the entry was empty after filtering): nothing tuned is active
        source = "explicit" if explicit else "heuristic"
    provenance = {
        "source": source,
        "key": {"workload": entry.get("workload"),
                "n_bucket": entry.get("n_bucket"),
                "p": entry.get("p"),
                "backend": entry.get("backend")} if entry else None,
        "table": path,
        "knobs": overrides,
        "explicit": sorted(explicit),
        "entry_provenance": entry.get("provenance") if entry else None,
    }
    return overrides, provenance


def coverage(table: Dict) -> Dict:
    """What the table covers: per (workload, backend), the N buckets
    and P counts with entries — the ``python -m sphexa_torch.telemetry tuning`` view
    that makes the gaps visible before a campaign relies on them."""
    cov: Dict[str, Dict] = {}
    for e in table.get("entries", ()):
        k = f"{e.get('workload')}/{e.get('backend')}"
        c = cov.setdefault(k, {"n_buckets": set(), "p": set()})
        c["n_buckets"].add(e.get("n_bucket"))
        c["p"].add(e.get("p"))
    return {k: {"n_buckets": sorted(v["n_buckets"]),
                "p": sorted(v["p"])} for k, v in sorted(cov.items())}
