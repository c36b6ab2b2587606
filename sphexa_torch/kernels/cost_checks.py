"""Card checks of the static cost layer (devtools/audit), shared by
chip_smoke.py's ``cost_path`` phase and tests/test_torch_gpu.py
(``-k cost``).

- ``registry_card_vs_cpu``: every audit registry entry, the two list-mode
  cases (``LIST_ENTRIES``) among them, tallied on the card and on the CPU
  (the kernels' plain versions there): per phase the FLOPs and both byte
  counts equal, and on the card every kernel launch charged once (the
  tally's kernel charges equal the ``LAUNCHES`` delta of the same run). A
  disagreement raises, naming the (phase, op) rows and the kernel charges
  that differ.
"""

from typing import Dict, List

from sphexa_torch.devtools.audit import registry
from sphexa_torch.devtools.audit.core import (
    EntryTrace,
    entries_from_namespace,
    entry_trace,
)
from sphexa_torch.devtools.audit.costmodel import cost_report, predict

#: the per-phase numbers the card and the CPU must agree on
COMPARED = ("flops", "hbm_lower", "hbm_upper")

#: the list-mode cases (audit registry entries)
LIST_SIDE = registry.LIST_SIDE
LIST_ENTRIES = (registry.step_std_lists, registry.step_ve_lists)
#: the kernels each list-mode case must charge, by name
LIST_KERNELS = {
    "step_std_lists": {"mark", "density_lists", "iad_lists", "momentum_energy_std_lists"},
    "step_ve_lists": {"mark", "density_lists", "ve_def_gradh_lists", "iad_lists",
                      "iad_divv_curlv_lists", "av_switches_lists", "momentum_energy_ve_lists"},
}


def tally_entry(entry, device: str) -> EntryTrace:
    """The process's one recorded run of a registry entry on ``device``
    (``core.entry_trace``); returns its trace (``tally``, ``launches``)."""
    trace = entry_trace(entry, device)
    cost_report(trace)
    return trace


def _op_diff(card, cpu, limit: int = 12) -> List[str]:
    """The (phase, op) rows whose count, FLOPs or bytes differ."""
    out = []
    for key in sorted(set(card.ops) | set(cpu.ops)):
        a, b = card.ops.get(key), cpu.ops.get(key)
        if a != b:
            out.append(f"{key}: card {a} cpu {b}")
    return out[:limit]


def registry_card_vs_cpu(names=None, device_model: str = "h100") -> Dict:
    """Every registry entry and list-mode case (or those ``names``)
    tallied on the card and on the CPU. Returns {entry: {"phases": n,
    "kernels": charges, "launches": LAUNCHES delta, "predicted_ms": on
    ``device_model``}}; raises on the first disagreement, or on a list-mode
    case that charged other kernels than its walks and build. A sharded
    entry is compared on rank 0's tallies (``audit_checks`` holds every
    rank's record)."""
    from sphexa_torch.kernels.audit_checks import record_sharded

    record_sharded()  # the sharded entries' spawns, together
    out = {}
    for entry in entries_from_namespace(vars(registry)):
        if names is not None and entry.name not in names:
            continue
        card = tally_entry(entry, "cuda")
        cpu = tally_entry(entry, "cpu")
        rc, rp = cost_report(card), cost_report(cpu)
        bad = []
        for phase in sorted(set(rc.phases) | set(rp.phases)):
            a, b = rc.phases.get(phase), rp.phases.get(phase)
            for k in COMPARED:
                va = getattr(a, k) if a is not None else None
                vb = getattr(b, k) if b is not None else None
                if va != vb:
                    bad.append(f"{phase}.{k}: card {va} cpu {vb}")
        for k in COMPARED:
            if getattr(rc.unattributed, k) != getattr(rp.unattributed, k):
                bad.append(f"unattributed.{k}: card {getattr(rc.unattributed, k)} "
                           f"cpu {getattr(rp.unattributed, k)}")
        if rc.kernels != rp.kernels:
            bad.append(f"kernel charges: card {rc.kernels} cpu {rp.kernels}")
        if bad:
            logs = [(a, b) for a, b in zip(card.tally.kernel_log, cpu.tally.kernel_log)
                    if a != b]
            raise AssertionError(f"{entry.name}: the card's tally differs from the CPU's: "
                                 f"{bad[:8]}; ops {_op_diff(card.tally, cpu.tally)}; "
                                 f"kernel charges (card, cpu) {logs[:4]}")
        if dict(rc.kernels) != card.launches:
            raise AssertionError(f"{entry.name}: kernel charges {dict(rc.kernels)} != "
                                 f"launches {card.launches}")
        want = LIST_KERNELS.get(entry.name)
        if want is not None and set(rc.kernels) != want:
            raise AssertionError(f"{entry.name}: charged {dict(rc.kernels)}, want each of "
                                 f"{sorted(want)}")
        pred = predict(rc, device_model)
        out[entry.name] = {"phases": len(rc.phases), "kernels": dict(rc.kernels),
                           "launches": card.launches, "predicted_ms": pred.total_ms,
                           "coverage": rc.coverage}
    return out

