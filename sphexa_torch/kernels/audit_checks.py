"""Card checks of the audit's trace rules, lowering lock and statecheck
(devtools/audit), shared by chip_smoke.py's ``audit_path`` phase and
tests/test_torch_gpu.py (``-k audit``).

- ``registry_card_vs_cpu_audit``: every audit registry entry (the list-mode
  cases and ``knob_inertness`` among them), recorded on the card and on the
  CPU (``core.entry_trace``: the same runs the cost layer's check tallied):
  the findings of every rule of the default gate, the lowering fingerprint
  and the schema row equal on the two devices and equal to the committed
  LOWERING_LOCK_TORCH.json and STATE_SCHEMA_TORCH.json; the fingerprint's
  ``launches`` equal to the kernel wrappers' counters over the card's run
  (``pair_engine.LAUNCHES``, which K12 and K13 count in too); and the host
  syncs JXA104's classifier finds (by ``file:line``) equal to those that
  ``torch.cuda.set_sync_debug_mode`` reports over one more run of the entry
  on the card (``deferred_checks.sync_sites``). The knob probes of JXA402
  run on both devices and fingerprint the same. A disagreement raises.
- ``sharded_card_vs_cpu_audit``: the nine sharded entries, each on two
  ranks sharing the card (gloo; NCCL with a card a rank) and on two gloo
  ranks on the CPU (``record_sharded``: one spawn a device and size for
  all of them, the three started together, the four card ranks
  ``preflight_on_card`` reads among them): the findings of
  every rule (none) equal on the two devices; each rank's fingerprint
  (its collective count and launch map among it), schema row and
  collective sequence (op, group, dtype, shape, bytes, peer, site) equal
  on the card, on the CPU and in the committed locks; each rank's launch
  map equal to its wrappers' counters; each rank's static toy peak
  (JXA202) beside the card's ``max_memory_allocated`` over the same
  tallied run (reset before it).
- ``preflight_on_card``: ``preflight`` on the card at ``--mesh 2`` and
  ``--mesh 4`` (exit 0 each), each rank's static peak beside its measured
  one, the h100 model's memory beside the card's ``total_memory``.
- ``audit_cli_on_card``: the default mode, ``lowering`` and ``schema`` of
  the CLI on the card against the committed files: exit 0 each.
"""

import contextlib
import dataclasses
import io
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

from sphexa_torch.devtools.audit import lowerdiff, registry, statecheck
from sphexa_torch.devtools.audit.core import (
    Auditor,
    audit_context,
    entries_from_namespace,
    entry_trace,
    set_audit_context,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def _on(device: str):
    prev = set_audit_context(dataclasses.replace(audit_context(), device=device))
    try:
        yield
    finally:
        set_audit_context(prev)


def _findings(entry, device: str):
    """The default gate's findings on ``device`` (errors raise)."""
    with _on(device):
        active, errors, skipped = Auditor().run_entries([entry])
    if errors or skipped:
        raise AssertionError(f"{entry.name} on {device}: {[e.message for e in errors]} "
                             f"{skipped}")
    return [f.format() for f in active]


def registry_card_vs_cpu_audit() -> Dict:
    """Every one-device registry entry's findings, fingerprint, schema,
    launches and host syncs, card against CPU and the committed files. Returns {entry:
    {"rows", "digest", "launches", "syncs", "findings"}}; raises on the
    first disagreement."""
    from sphexa_torch.kernels.deferred_checks import sync_sites

    old_cwd = os.getcwd()
    os.chdir(_ROOT)  # the committed files by their repository paths
    try:
        lock = lowerdiff.load_lock(lowerdiff.DEFAULT_LOCK_PATH)
        schema = statecheck.load_lock(statecheck.DEFAULT_SCHEMA_PATH)
        out = {}
        for entry in entries_from_namespace(vars(registry)):
            if entry.mesh_axes:
                continue  # sharded_card_vs_cpu_audit
            card, cpu = entry_trace(entry, "cuda"), entry_trace(entry, "cpu")
            fc, fp = _findings(entry, "cuda"), _findings(entry, "cpu")
            if fc != fp or fc:
                raise AssertionError(f"{entry.name}: findings on the card {fc}, on the CPU "
                                     f"{fp}")
            lc, lp = (lowerdiff.lowering_fingerprint(t) for t in (card, cpu))
            if lc.lock_payload() != lp.lock_payload():
                raise AssertionError(
                    f"{entry.name}: the card's record differs from the CPU's: "
                    + " / ".join(lowerdiff.structural_diff(entry.name, lp.lock_payload(), lc,
                                                           verbose=True)))
            if not lowerdiff.matches(lock[entry.name], lc) \
                    or lock[entry.name] != lc.lock_payload():
                raise AssertionError(f"{entry.name}: the card's record differs from the "
                                     f"lock: {lowerdiff.structural_diff(entry.name, lock[entry.name], lc)}")
            if lc.launches != card.launches:
                raise AssertionError(f"{entry.name}: the record's launches {lc.launches}, the "
                                     f"wrappers' counters {card.launches}")
            with _on("cuda"):
                sc = statecheck.entry_schema(card)
            with _on("cpu"):
                sp = statecheck.entry_schema(cpu)
            if not sc == sp == schema[entry.name]:
                raise AssertionError(f"{entry.name}: schema rows differ: "
                                     f"{statecheck.schema_diff(entry.name, sp, sc)}; lock "
                                     f"{statecheck.schema_diff(entry.name, schema[entry.name], sc)}")
            rows = {r.site for r in card.tally.rows if r.flag == "sync"}
            case = card.case
            seen = set(sync_sites(lambda: case.fn(*case.args)))
            if rows != seen:
                raise AssertionError(f"{entry.name}: JXA104's sync sites {sorted(rows)}, the "
                                     f"card's sync debug mode {sorted(seen)}")
            out[entry.name] = {"rows": lc.eqns, "digest": lc.digest, "launches": lc.launches,
                               "syncs": sorted(rows), "grow": sc["grow"]}
        probes = {}
        for device in ("cuda", "cpu"):
            with _on(device):
                probes[device] = {p.knob: (p.base.digest, p.off.digest, p.off.launches)
                                  for p in lowerdiff.production_knob_probes()}
        if probes["cuda"] != probes["cpu"]:
            raise AssertionError(f"knob probes: card {probes['cuda']}, CPU {probes['cpu']}")
        out["knob_probes"] = sorted(probes["cuda"])
        return out
    finally:
        os.chdir(old_cwd)


def _collectives(view):
    return [(c.op, c.group, c.size, c.dtype, c.shape, c.nbytes, c.peer, c.reduce, c.site)
            for c in view.tally.collectives]


#: the spawns of the sharded entries the card's checks read: (device, P)
SHARDED_RUNS = (("cuda", 2), ("cpu", 2), ("cuda", 4))


def record_sharded() -> float:
    """Record the registry's sharded entries in the ``SHARDED_RUNS`` spawns,
    started together (threads; a spawn already made is skipped): the
    records ``cost_checks``, ``sharded_card_vs_cpu_audit``, the CLI's
    modes and ``preflight_on_card`` read. Returns the seconds it took."""
    import time

    from sphexa_torch.devtools.audit.core import run_sharded

    t0 = time.perf_counter()
    entries = [e for e in entries_from_namespace(vars(registry)) if e.mesh_axes]
    with ThreadPoolExecutor(len(SHARDED_RUNS)) as pool:
        for f in [pool.submit(run_sharded, entries, d, P) for d, P in SHARDED_RUNS]:
            f.result()
    return time.perf_counter() - t0


def sharded_card_vs_cpu_audit() -> Dict:
    """The sharded entries' records on two ranks, card against CPU and the
    committed files (module docstring). Returns {entry: {"ranks": [{"rows",
    "collectives", "launches", "static_peak", "max_memory_allocated",
    "allocated_before"}], "findings": []}}; raises on the first
    disagreement."""
    from sphexa_torch.devtools.audit.spmd import spmd_report

    old_cwd = os.getcwd()
    os.chdir(_ROOT)
    try:
        lock = lowerdiff.load_lock(lowerdiff.DEFAULT_LOCK_PATH)
        schema = statecheck.load_lock(statecheck.DEFAULT_SCHEMA_PATH)
        entries = [e for e in entries_from_namespace(vars(registry)) if e.mesh_axes]
        record_sharded()
        out = {}
        for entry in entries:
            card, cpu = entry_trace(entry, "cuda"), entry_trace(entry, "cpu")
            fc, fp = _findings(entry, "cuda"), _findings(entry, "cpu")
            if fc != fp or fc:
                raise AssertionError(f"{entry.name}: findings on the card {fc}, on the CPU "
                                     f"{fp}")
            with _on("cuda"):
                rep = spmd_report(card, audit_context())
            lrows = lowerdiff.rank_rows(lock[entry.name])
            srows = schema[entry.name]["ranks"]
            ranks = []
            for r, (vc, vp) in enumerate(zip(card.ranks, cpu.ranks)):
                label = f"{entry.name}[rank {r}]"
                lc, lp = lowerdiff.lowering_fingerprint(vc), lowerdiff.lowering_fingerprint(vp)
                if lc.lock_payload() != lp.lock_payload():
                    raise AssertionError(
                        f"{label}: the card's record differs from the CPU's: "
                        + " / ".join(lowerdiff.structural_diff(label, lp.lock_payload(), lc,
                                                               verbose=True)))
                if lrows[r] != lc.lock_payload():
                    raise AssertionError(f"{label}: the card's record differs from the lock: "
                                         f"{lowerdiff.structural_diff(label, lrows[r], lc)}")
                if lc.launches != vc.launches:
                    raise AssertionError(f"{label}: the record's launches {lc.launches}, the "
                                         f"wrappers' counters {vc.launches}")
                if _collectives(vc) != _collectives(vp):
                    raise AssertionError(f"{label}: collectives on the card {_collectives(vc)}, "
                                         f"on the CPU {_collectives(vp)}")
                with _on("cuda"):
                    sc = statecheck.entry_schema(vc)
                with _on("cpu"):
                    sp = statecheck.entry_schema(vp)
                if not sc == sp == srows[r]:
                    raise AssertionError(f"{label}: schema rows differ: "
                                         f"{statecheck.schema_diff(label, sp, sc)}; lock "
                                         f"{statecheck.schema_diff(label, srows[r], sc)}")
                ranks.append({"rows": lc.eqns, "collectives": lc.collectives,
                              "launches": lc.launches,
                              "static_peak": rep.ranks[r].toy_peak_bytes,
                              "max_memory_allocated": vc.max_allocated,
                              "allocated_before": vc.run.allocated_before})
            out[entry.name] = {"ranks": ranks, "findings": fc}
        return out
    finally:
        os.chdir(old_cwd)


def preflight_on_card() -> Dict:
    """``preflight`` on the card at ``--mesh 2`` and ``--mesh 4``, from the
    repository's root: exit 0 each (else raises). Returns {"mesh2",
    "mesh4": {entry: [(rank, static peak, max_memory_allocated)]}, "model_memory",
    "total_memory"}."""
    import json

    import torch

    from sphexa_torch.devtools.audit import cli
    from sphexa_torch.devtools.audit.devices import get_device

    old_cwd = os.getcwd()
    os.chdir(_ROOT)
    out = {}
    try:
        for P in (2, 4):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["preflight", "--mesh", str(P), "--json"])
            if rc != 0:
                raise AssertionError(f"preflight --mesh {P} on the card exited {rc}: "
                                     f"{buf.getvalue()[-3000:]}")
            payload = json.loads(buf.getvalue())
            out[f"mesh{P}"] = {e["entry"]: [(r["rank"], r["toy_peak_bytes"], r["max_allocated"])
                                            for r in e["ranks"]]
                               for e in payload["entries"] if e["mesh_size"] > 1}
    finally:
        os.chdir(old_cwd)
    out["model_memory"] = get_device("h100").memory_bytes
    out["total_memory"] = torch.cuda.get_device_properties(0).total_memory
    return out


def audit_cli_on_card() -> Dict[str, int]:
    """The CLI's default mode, ``lowering`` and ``schema`` on the card from
    the repository's root: their exit codes (each 0, else raises)."""
    from sphexa_torch.devtools.audit import cli

    old_cwd = os.getcwd()
    os.chdir(_ROOT)
    try:
        rcs, outs = {}, {}
        for mode in ("audit", "lowering", "schema"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rcs[mode] = cli.main([] if mode == "audit" else [mode])
            outs[mode] = buf.getvalue()
    finally:
        os.chdir(old_cwd)
    bad = {m: outs[m][-2000:] for m, rc in rcs.items() if rc != 0}
    if bad:
        raise AssertionError(f"the audit CLI on the card: {rcs}: {bad}")
    return rcs
