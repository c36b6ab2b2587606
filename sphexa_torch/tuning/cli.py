"""``python -m sphexa_torch.tuning``: the sweep driver of the port (the
JAX package's ``sphexa-tune``).

    python -m sphexa_torch.tuning --case sedov --side 100 \
        --knobs group,cell_target,gap,list_skin_rel --budget 8 \
        --out tune-out --write-table TUNING_TABLE_TORCH.json
    python -m sphexa_torch.tuning --device cpu --case sedov --side 8 \
        --knobs cell_target --budget 3 --commit best

Replays a workload (a named init case, or the one a telemetry run's
manifest describes), sweeps a knob subset under a candidate budget, and
leaves the artifacts a production run does: the sweep dir is a telemetry
run dir (manifest.json, events.jsonl with one ``sweep`` event per
candidate, the flight recorder armed so that a hard death leaves
blackbox.json), and ``--write-table`` commits the winner into a tuning
table entry whose provenance names the card and its power limit (as
nvidia-smi gives them) or ``cpu``. The flags are the JAX CLI's, plus
``--device``: the sweep runs on the CUDA device unless ``--device cpu``
is given, and refuses to start without one. A ``static-cost:`` objective
(the JAX package's jaxpr cost model) and ``--devices`` above 1 (a sweep
over ranks) are not available here and exit 2. Exit codes: 0 = the sweep
completed with a usable measurement, 1 = no candidate measured ok, 2 =
unusable input.
"""

import argparse
import dataclasses
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sphexa-torch-tune",
        description="workload-replay autotuner of the PyTorch/CUDA port, scored "
                    "by its telemetry",
    )
    src = p.add_mutually_exclusive_group()
    src.add_argument("--case", default=None,
                     help="named init case to replay (sedov, evrard, ...)")
    src.add_argument("--from-run", default=None, dest="from_run",
                     help="telemetry run dir: replay the workload its "
                          "manifest describes")
    p.add_argument("--side", type=int, default=20,
                   help="particles per cube side with --case (N = side^3)")
    p.add_argument("--prop", default="std", help="propagator with --case")
    p.add_argument("--backend", default="auto",
                   choices=("auto", "pallas", "xla"))
    p.add_argument("--theta", type=float, default=0.5)
    p.add_argument("--devices", type=int, default=None,
                   help="ranks (only 1: a sweep over ranks is not available)")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu' (the kernels' plain versions)")
    p.add_argument("--knobs", default="target_block,cell_target,gap",
                   help="comma-separated knob subset to sweep "
                        "(registry names, sphexa_torch/tuning/knobs.py)")
    p.add_argument("--budget", type=int, default=16,
                   help="max measured candidates, baseline included")
    p.add_argument("--steps", type=int, default=6,
                   help="measured steps per candidate (one deferred "
                        "window unless check_every is being swept)")
    p.add_argument("--warmup", type=int, default=1,
                   help="unmeasured warmup windows per candidate")
    p.add_argument("--objective", default="per_step_s",
                   help="per_step_s; or phase:<name> to score one phase of "
                        "the device-time table (runs under a torch.profiler "
                        "capture). static-cost:<name> (the JAX package's "
                        "chip-free cost model) exits 2")
    p.add_argument("--cost-device", default="v5e", dest="cost_device",
                   help="accepted for the JAX CLI's command lines; unused")
    p.add_argument("--out", default="tune-out",
                   help="sweep run dir (events.jsonl / manifest / "
                        "blackbox land here)")
    p.add_argument("--write-table", default=None, dest="write_table",
                   help="tuning table to upsert the result into "
                        "(the port's: TUNING_TABLE_TORCH.json)")
    p.add_argument("--commit", default="improved",
                   choices=("improved", "best", "none"),
                   help="what --write-table commits: 'improved' only a "
                        "knob set that beat the baseline; 'best' the "
                        "best ok candidate even at zero/negative win "
                        "(pin a measured config; CI smoke); 'none' dry "
                        "run")
    p.add_argument("--workload", default=None,
                   help="table workload class (default: the case name)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--format", default="text", choices=("text", "json"))
    return p




def card_label(device) -> str:
    """The sweep's hardware for a table entry's provenance: the card's name
    and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, or "cpu"."""
    import subprocess

    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        line = ""
    return line or torch.cuda.get_device_name(dev)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    # resolving the spec before touching the device keeps bad input cheap
    from sphexa_torch.tuning import (
        ReplaySpec, domains_for, load_table, make_entry, measure_candidate,
        new_table, run_sweep, save_table, spec_from_manifest, upsert_entry,
    )
    from sphexa_torch.tuning.replay import STATIC_COST

    try:
        if args.objective.startswith(STATIC_COST):
            raise ValueError(f"objective {args.objective!r}: the JAX package's static "
                             f"cost model has no counterpart in the port; score on the "
                             f"card with per_step_s or phase:<name>")
        if args.from_run:
            spec = spec_from_manifest(args.from_run)
            if args.device is not None:
                spec = dataclasses.replace(spec, device=args.device)
        else:
            from sphexa_torch.init import CASES, split_case_spec

            case = args.case or "sedov"
            base, _ = split_case_spec(case)
            if base not in CASES:
                raise ValueError(f"unknown case {case!r} "
                                 f"(known: {sorted(CASES)})")
            spec = ReplaySpec(case=case, side=args.side, prop=args.prop,
                              backend=args.backend, theta=args.theta,
                              devices=args.devices, device=args.device)
        if spec.devices is not None and spec.devices > 1:
            raise ValueError(f"--devices {spec.devices}: a sweep over ranks is not "
                             f"available in the port (one device only)")
        domains = domains_for(
            [k for k in args.knobs.split(",") if k])
    except (FileNotFoundError, ValueError, KeyError, OSError,
            json.JSONDecodeError) as e:
        print(f"sphexa-torch-tune: {e}", file=sys.stderr)
        return 2

    from sphexa_torch.device import resolve_device
    from sphexa_torch.simulation import resolve_backend
    from sphexa_torch.telemetry import (
        FlightRecorder, JsonlSink, Telemetry, write_manifest,
    )

    # on the card unless --device cpu: no card raises here, before the sweep
    # could turn it into failed candidates
    device = resolve_device(spec.device)
    os.makedirs(args.out, exist_ok=True)
    telemetry = Telemetry(sinks=[JsonlSink(
        os.path.join(args.out, "events.jsonl"))])
    recorder = FlightRecorder(args.out, telemetry=telemetry)
    telemetry.sinks.append(recorder.sink)
    recorder.install()
    recorder.manifest = write_manifest(
        args.out,
        config={"case": spec.case, "side": spec.side, "prop": spec.prop,
                "backend": spec.backend, "theta": spec.theta,
                "devices": spec.devices, "device": spec.device,
                "knobs": args.knobs, "budget": args.budget,
                "steps": args.steps, "warmup": args.warmup,
                "objective": args.objective},
        particles=spec.n, device=device,
        extra={"case": spec.case, "prop": spec.prop, "sweep": True},
    )

    say = (lambda s: None) if args.quiet else \
        (lambda s: print(f"# tune {s}"))
    trace_root = os.path.join(args.out, "trace")
    counter = {"i": 0}

    def measure(knobs):
        td = None
        if args.objective.startswith("phase:"):
            td = os.path.join(trace_root, f"cand{counter['i']}")
        counter["i"] += 1
        return measure_candidate(spec, knobs, steps=args.steps,
                                 warmup=args.warmup,
                                 objective=args.objective, trace_dir=td)

    result = run_sweep(measure, domains, args.budget,
                       telemetry=telemetry, objective=args.objective,
                       log=say)

    base = result["baseline"]
    best = result["best"]
    usable = base is not None and base.get("status") == "ok"
    win = None
    if usable and result["improved"]:
        win = (base["value"] - best["value"]) / base["value"]

    backend = resolve_backend(spec.backend)
    workload = args.workload or spec.case
    # the decision event: what the sweep concluded, in the same stream as
    # the per-candidate evidence
    telemetry.event(
        "tuning", source="sweep", workload=workload, backend=backend,
        n=spec.n, p=spec.devices or 1, objective=args.objective,
        knobs=best["knobs"], improved=result["improved"],
        candidates=result["candidates"],
        **({"win": round(win, 4)} if win is not None else {}),
    )

    wrote = None
    commit_knobs = best["knobs"]
    if args.write_table and args.commit == "best" and not commit_knobs:
        # the baseline won but the caller wants a pinned measured config:
        # commit the best-scoring non-empty ok candidate
        ok = [r for r in result["history"]
              if r.get("status") == "ok" and r["knobs"]
              and isinstance(r.get("value"), (int, float))]
        if ok:
            commit_knobs = min(ok, key=lambda r: r["value"])["knobs"]
    if (args.write_table and args.commit != "none" and commit_knobs
            and (result["improved"] or args.commit == "best")):
        try:
            table = load_table(args.write_table)
        except (FileNotFoundError, ValueError):
            table = new_table()
        cand = next(r for r in result["history"]
                    if r["knobs"] == commit_knobs)
        entry = make_entry(
            workload, spec.n, spec.devices or 1, backend, commit_knobs,
            provenance={
                "source_run": os.path.abspath(args.out),
                "created": time.strftime("%Y-%m-%d"),
                "objective": args.objective,
                "baseline": base.get("value") if usable else None,
                "best": cand.get("value"),
                "win": round(win, 4) if win is not None else None,
                "device": card_label(device),
            },
        )
        upsert_entry(table, entry)
        save_table(args.write_table, table)
        wrote = args.write_table

    recorder.close()
    telemetry.close()

    if args.format == "json":
        print(json.dumps({"spec": vars(args), "baseline": base,
                          "best": best if result["improved"] else None,
                          "win": win, "candidates": result["candidates"],
                          "table": wrote},
                         default=str))
    else:
        if usable:
            say(f"baseline {args.objective}={base['value']:.6g}")
        if result["improved"]:
            say(f"best {best['knobs']} -> {best['value']:.6g} "
                f"(win {100 * win:.1f}%)")
        else:
            say("no candidate beat the baseline")
        if wrote:
            say(f"table entry written to {wrote}")
    ok_any = any(r.get("status") == "ok" for r in result["history"])
    return 0 if ok_any else 1


if __name__ == "__main__":
    sys.exit(main())
