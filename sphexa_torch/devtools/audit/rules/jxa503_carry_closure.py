"""JXA503: carry closure: a step's output state is its input state.

The driver (``Simulation.step``), a replay and an ensemble all need the
``SimState`` a step returns to have the structure, dtypes and shapes of
the one it took (sphexa_torch/state.py): a ``None`` aux slot becoming a
value (or back) means a propagator family wrote a slot it does not own,
and a leaf that changes dtype or shape is not a carry. Runs on every
entry whose case declares ``carry`` (the step entries).
"""

from typing import List

from sphexa_torch.devtools.audit.core import EntryTrace, register
from sphexa_torch.devtools.common import Finding


def _meta(leaf) -> str:
    if leaf is None:
        return "None"
    if hasattr(leaf, "dtype") and hasattr(leaf, "shape"):
        return f"{str(leaf.dtype).replace('torch.', '')}{list(leaf.shape)}"
    return type(leaf).__name__


@register(
    "JXA503", "carry-closure",
    "the state a step returns differs from the one it took in structure "
    "(None<->value slots) or leaf dtype and shape",
)
def check(trace: EntryTrace) -> List[Finding]:
    case = trace.case
    if case.carry is None:
        return []
    from sphexa_torch.devtools.audit.statecheck import flatten

    before = {p: _meta(v) for p, v in flatten(case.args)}
    after = {p: _meta(v) for p, v in flatten(case.carry(case.args, trace.out))}
    if set(before) != set(after):
        only_in = sorted(set(before) - set(after))
        only_out = sorted(set(after) - set(before))
        return [trace.finding(
            "JXA503",
            "the step changes its carry's structure: "
            + "; ".join(b for b in (
                f"leaves only in its input: {', '.join(only_in[:6])}" if only_in else "",
                f"leaves only in its output: {', '.join(only_out[:6])}" if only_out else "")
                if b),
        )]
    return [
        trace.finding(
            "JXA503",
            f"carry leaf {path} is not closed under the step: {before[path]} in, "
            f"{after[path]} out — a None<->value flip is a slot the family does not "
            f"own; commit the leaf to its policy dtype and shape where the state is "
            f"built.",
        )
        for path in sorted(before) if before[path] != after[path]
    ][:8]
