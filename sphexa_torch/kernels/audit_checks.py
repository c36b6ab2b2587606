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
- ``audit_cli_on_card``: the default mode, ``lowering`` and ``schema`` of
  the CLI on the card against the committed files: exit 0 each.
"""

import contextlib
import dataclasses
import io
import os
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
    """Every registry entry's findings, fingerprint, schema, launches and
    host syncs, card against CPU and the committed files. Returns {entry:
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
