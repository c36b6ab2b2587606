"""Search driver of the port (sphexa_tpu/tuning/search.py): a staged
grid and coordinate descent under a budget.

Deterministic by design; the measurement is the expensive, noisy part:

* stage 0 measures the baseline (empty knob dict = the heuristics), so
  every reported win is relative to what the run would have done;
* then coordinate-descent passes in registry order: one knob at a time,
  scanning its declared domain around the incumbent, keeping a strictly
  better ``ok`` measurement (``overflow``/``failed`` candidates are
  recorded but never become the incumbent);
* passes repeat until a full pass improves nothing or the budget is spent.

Every attempt, dead ones included, is emitted as a ``sweep`` event, and a
candidate that raises becomes a ``failed`` event instead of ending the
sweep. The module is pure over the ``measure`` callable.
"""

from typing import Callable, Dict, Optional, Tuple

from sphexa_torch.tuning.knobs import KNOBS


def domains_for(names) -> Dict[str, Tuple]:
    """Registry domains for a knob-name subset, in registry order (the
    coordinate order — earlier knobs are swept first)."""
    bad = sorted(set(names) - set(KNOBS))
    if bad:
        raise KeyError(f"unknown knobs {bad} (known: {sorted(KNOBS)})")
    want = set(names)
    return {k: spec.domain for k, spec in KNOBS.items() if k in want}


def run_sweep(measure: Callable[[Dict], Dict],
              domains: Dict[str, Tuple],
              budget: int,
              telemetry=None,
              objective: str = "per_step_s",
              log: Callable = lambda s: None) -> Dict:
    """Spend up to ``budget`` measurements of ``measure(knobs) ->
    {status, value, ...}`` (lower value better); returns ``{baseline,
    best, improved, history, candidates}``. ``best`` covers only knobs
    that beat the incumbent — an empty best dict means the heuristics
    already won."""
    history = []
    spent = 0

    def attempt(knobs: Dict) -> Optional[Dict]:
        nonlocal spent
        if spent >= budget:
            return None
        try:
            r = dict(measure(dict(knobs)))
        except Exception as e:  # dead candidate, not dead sweep
            r = {"status": "failed", "value": None,
                 "error": f"{type(e).__name__}: {e}"}
        rec = {"candidate": spent, "knobs": dict(knobs), **r}
        history.append(rec)
        if telemetry is not None:
            telemetry.event(
                "sweep", candidate=spent, knobs=dict(knobs),
                status=rec.get("status"), objective=objective,
                value=rec.get("value"),
                **({"error": rec["error"]} if "error" in rec else {}),
            )
        log(f"candidate {spent}: {knobs or '{baseline}'} -> "
            f"{rec.get('status')} value={rec.get('value')}")
        spent += 1
        return rec

    def usable(rec) -> bool:
        return (rec is not None and rec.get("status") == "ok"
                and isinstance(rec.get("value"), (int, float)))

    baseline = attempt({})
    best_knobs: Dict = {}
    best_value = baseline["value"] if usable(baseline) else float("inf")

    improved_any, improved_pass = False, True
    while improved_pass and spent < budget:
        improved_pass = False
        for name, domain in domains.items():
            incumbent = best_knobs.get(name, domain[0])
            for v in domain:
                if v == incumbent or spent >= budget:
                    continue
                rec = attempt({**best_knobs, name: v})
                if usable(rec) and rec["value"] < best_value:
                    best_knobs = dict(rec["knobs"])
                    best_value = rec["value"]
                    improved_any = improved_pass = True
            if spent >= budget:
                break

    return {
        "baseline": baseline,
        "best": {"knobs": best_knobs, "value": best_value},
        "improved": improved_any,
        "history": history,
        "candidates": spent,
    }
