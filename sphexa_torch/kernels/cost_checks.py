"""Card checks of the static cost layer (devtools/audit), shared by
chip_smoke.py's ``cost_path`` phase and tests/test_torch_gpu.py
(``-k cost``).

- ``registry_card_vs_cpu``: every audit registry entry, and the two
  list-mode cases (``LIST_ENTRIES``), tallied on the card and on the CPU
  (the kernels' plain versions there): per phase the FLOPs and both byte
  counts equal, and on the card every kernel launch charged once (the
  tally's kernel charges equal the ``LAUNCHES`` delta of the same run). A
  disagreement raises, naming the (phase, op) rows and the kernel charges
  that differ.
"""

import dataclasses
from typing import Dict, List

from sphexa_torch.devtools.audit import registry
from sphexa_torch.devtools.audit.core import (
    EntryCase,
    EntryTrace,
    audit_context,
    entries_from_namespace,
    entrypoint,
    set_audit_context,
)
from sphexa_torch.devtools.audit.costmodel import cost_report, predict

#: the per-phase numbers the card and the CPU must agree on
COMPARED = ("flops", "hbm_lower", "hbm_upper")

#: the side of the list-mode cases: Noh's grid does not fold there, so its
#: steps take the lists (the registry's side-6 entries all stream)
LIST_SIDE = 12


def _list_case(prop: str) -> EntryCase:
    """One list build (which sorts the Simulation's state) and one step on
    the lists from the sorted state, of Noh at ``LIST_SIDE`` with ``prop``:
    K5 and the prop's K6 walks in their mask modes. The untallied warm-up
    sorts the initial state, so that every tallied run starts from the
    same sorted state."""
    from sphexa_torch.propagator import step_sim_state

    sim = registry._sim("noh", LIST_SIDE, prop, audit_context().device)
    if not sim._use_lists:
        raise AssertionError(f"noh {LIST_SIDE} {prop}: the step streams, no list mode")

    def run():
        sim._rebuild_lists()
        return step_sim_state(sim._step_fn, sim.sim_state, sim.cfg, sim.gtree,
                              sim._aux_cfg, lists=sim.lists)

    return EntryCase(fn=run)


@entrypoint("step_std_lists")
def step_std_lists():
    return _list_case("std")


@entrypoint("step_ve_lists")
def step_ve_lists():
    return _list_case("ve")


#: the list-mode cases
LIST_ENTRIES = (step_std_lists, step_ve_lists)
#: the kernels each list-mode case must charge, by name
LIST_KERNELS = {
    "step_std_lists": {"mark", "density_lists", "iad_lists", "momentum_energy_std_lists"},
    "step_ve_lists": {"mark", "density_lists", "ve_def_gradh_lists", "iad_lists",
                      "iad_divv_curlv_lists", "av_switches_lists", "momentum_energy_ve_lists"},
}


def tally_entry(entry, device: str) -> EntryTrace:
    """Build and tally one registry entry on ``device``; returns its trace
    (``tally``, ``launches``)."""
    prev = set_audit_context(dataclasses.replace(audit_context(), device=device))
    try:
        trace = EntryTrace(entry, entry.build())
        cost_report(trace)
    finally:
        set_audit_context(prev)
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
    case that charged other kernels than its walks and build."""
    out = {}
    for entry in entries_from_namespace(vars(registry)) + list(LIST_ENTRIES):
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

