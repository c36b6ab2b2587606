"""JXA402: knob-inertness meta-rule.

Every tuning knob that declares an ``off_sentinel`` in tuning/knobs.py
promises that resolving the knob to that value through ``tuned=`` leaves
the step's record (the lowering lock's digest and launch map) identical
to never naming the knob. The probes live on ``EntryCase.knob_probes``:
the registry's ``knob_inertness`` entry wires
``lowerdiff.production_knob_probes``, which runs
``knobs.validate_off_sentinels()`` first, so that a renamed resolution
site fails loudly instead of the probe passing vacuously. A new knob adds
``off_sentinel=...`` to its KnobSpec and is probed with no code of its
own.
"""

from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, register
from sphexa_torch.devtools.common import Finding


@register(
    "JXA402", "knob-inertness",
    "a tuning knob's declared off sentinel changes the step's record: the "
    "off path leaks into the program that never names the knob",
)
def check(trace: EntryTrace) -> List[Finding]:
    if trace.case.knob_probes is None:
        return []
    from sphexa_torch.devtools.audit.lowerdiff import deltas, matches

    findings: List[Finding] = []
    for probe in trace.case.knob_probes():
        base = probe.base.lock_payload()
        if matches(base, probe.off):
            continue
        d = deltas(base, probe.off)
        where = (f"first divergence at row #{d['first_divergence']} "
                 f"(phase {d['first_divergence_phase']})"
                 if d["first_divergence"] is not None else "constants differ")
        findings.append(trace.finding(
            "JXA402",
            f"knob {probe.knob!r}: tuned={{{probe.knob}: {probe.off_value!r}}} does not "
            f"run as leaving the knob unset ({probe.detail}); row delta {d['eqns']:+d}, "
            f"{where}"
            + (f", launches {d['launches']}" if d["launches"] else "")
            + (f", phases changed: {', '.join(d['phases_changed'][:3])}"
               if d["phases_changed"] else "")
            + " — the off sentinel must be indistinguishable from absence (fix the "
              "resolution default or the sentinel in tuning/knobs.py).",
        ))
    return findings
