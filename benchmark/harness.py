"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the metrics.

A cell ``<config>.<traffic>`` names ``configs/<config>.json`` (the sizes
and constants, and ``init`` and ``prop``, which name ``inits/<init>.py``
and ``reference/<prop>.py``) and ``traffic/<traffic>.json`` (the check
window, list mode, warm-up steps and the traced stretch). Each metric of
``BENCHMARK.json`` is read by ``metrics/<name>.py``'s ``read(ctx)``,
which returns a number or None (nothing to read in this run). The
limits of the comparison are ``limits/<config>.json``.

The window starts after the warm-up (which builds every kernel the
cell's steps use) and runs ``Simulation.step()`` until ``seconds`` have
passed; every step started in it completes in it. Set-up is process
start to the window's start. A traced run captures its first
``trace_steps`` window steps with torch.profiler."""

import contextlib
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
#: scratch files of a run (the exported trace), inside the checkout
WORK = os.path.join(BENCH, ".work")
#: top-level modules that must not be loaded (the port is measured, not
#: the JAX package it was ported from)
FORBIDDEN = ("jax", "jaxlib", "flax", "sphexa_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(workload: str) -> tuple:
    """(BENCHMARK.json, the workload's entry, its configuration, its traffic)."""
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    cfg = load_json(os.path.join(ROOT, cfg_entry["file"]))
    mix = load_json(os.path.join(BENCH, "traffic", f"{entry['traffic']}.json"))
    return spec, entry, cfg, mix


def metric_reader(name: str) -> Callable:
    """``read`` of metrics/<name>.py."""
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def initial_state(ic: dict) -> Dict[str, np.ndarray]:
    """The input of the first step as the harness made it (float32)."""
    f = {k: np.asarray(v, np.float32) for k, v in ic["fields"].items()}
    n = f["x"].shape[0]
    dt = np.float32(ic["scalars"]["min_dt"])
    out = dict(f)
    for a, v in (("x_m1", "vx"), ("y_m1", "vy"), ("z_m1", "vz")):
        out[a] = (f[v] * dt).astype(np.float32)
    for k in ("temp_lo", "du", "du_m1"):
        out[k] = np.zeros(n, np.float32)
    out["ttot"] = np.float32(0.0)
    out["min_dt"] = dt
    out["min_dt_m1"] = np.float32(ic["scalars"]["min_dt_m1"])
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=20)
        return p.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(workload: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        overrides: Optional[dict] = None, fault: Optional[Callable] = None,
        log=print, keep: Optional[dict] = None) -> Dict:
    """Run ``workload`` once and return the result line (a dict); ``log``
    takes the lines for standard error. ``overrides`` replace keys of the
    configuration and the traffic (``{"config": {...}, "traffic": {...}}``:
    the tests' small sizes); ``fault(sim)`` breaks the timed path after
    the warm-up (the tests' faults); ``keep``, a dict, receives the
    readings and the compared steps' input states (the calibration)."""
    import torch

    from benchmark import inits, program
    from benchmark.reference import check

    spec, entry, cfg, mix = resolve(workload)
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        mix = {**mix, **overrides.get("traffic", {})}
    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ic = inits.make(cfg, seed)
    first_in = initial_state(ic)
    n = first_in["x"].shape[0]
    sim = program.make_simulation(ic, cfg, mix, device)
    attempted = failed = 0
    errors = []
    # the ledger's rows by iteration (under a check window they land at
    # its flush)
    rows_by_it: Dict[int, dict] = {}

    def drain():
        for r in sim.drain_science():
            rows_by_it[int(r["it"])] = r

    first_out = None
    for k in range(int(mix["warmup_steps"])):
        sim.step()
        drain()
        if k == 0:
            first_out = program.to_host(program.snapshot(sim))
    sim.flush()
    drain()
    first_row = rows_by_it.get(1)
    trace_steps = int(mix.get("trace_steps", 0)) if trace else 0
    trace_path = os.path.join(WORK, f"trace.{os.getpid()}.json")
    prof = None
    if trace_steps:
        # the profiler starts here, with a step of its own to warm it up
        # (its first launch costs seconds); the window's first
        # ``trace_steps`` steps are captured and exported as they complete
        os.makedirs(WORK, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=trace_steps, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(trace_path))
        prof.start()
        sim.step()
        drain()
        prof.step()
    if cuda:
        torch.cuda.synchronize()
    if fault is not None:
        fault(sim)
    setup_s = time.perf_counter() - t_start
    it_w0 = sim.iteration
    c0 = {"rebuilds": sim.rebuilds, "replays": sim.replays, "rollbacks": sim.rollbacks,
          "reconfigures": sim.reconfigures}
    captured = []
    step_s, dts, rebuilt = [], [], []
    last = None

    def span(name):
        return torch.profiler.record_function(name) if prof is not None else \
            contextlib.nullcontext()

    t0 = time.perf_counter()
    t_end = t0
    while t_end - t0 < seconds:
        prev = program.snapshot(sim)
        if prof is not None and (attempted == 0 or attempted == trace_steps - 1):
            captured.append(prev)
        b0 = sim.rebuilds
        attempted += 1
        ta = time.perf_counter()
        try:
            with span("bench/step"):
                sim.step()
            with span("bench/ledger"):
                drain()
        except Exception as e:  # a step the port could not complete ends the window
            failed += 1
            errors.append(f"{type(e).__name__}: {e}")
            t_end = time.perf_counter()
            break
        t_end = time.perf_counter()
        step_s.append(t_end - ta)
        rebuilt.append(sim.rebuilds > b0)
        last = (prev, program.snapshot(sim), sim.iteration, sim.rollbacks)
        if prof is not None:
            prof.step()
            if attempted == trace_steps:
                prof.stop()
                prof = None
    if not failed:
        # the last check window is verified inside the window, as the CLI
        # verifies it before its report
        try:
            sim.flush()
            drain()
        except Exception as e:
            failed += 1
            errors.append(f"{type(e).__name__}: {e}")
        t_end = time.perf_counter()
        if last is not None and sim.rollbacks != last[3] and sim.iteration == last[2]:
            last = (last[0], program.snapshot(sim), last[2], last[3])
    window_s = t_end - t0
    for it in sorted(rows_by_it):
        r = rows_by_it[it]
        if it > it_w0:
            if not (math.isfinite(r["dt"]) and math.isfinite(r["etot"])):
                failed += 1
                errors.append(f"non-finite step {it}: dt {r['dt']}, etot {r['etot']}")
                break
            dts.append(r["dt"])
    if last is not None:
        last = (last[0], last[1], rows_by_it.get(last[2]))
    if prof is not None:  # the window ended inside the traced stretch
        prof.stop()
        prof = None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    counters = {k: getattr(sim, k) - v for k, v in c0.items()}
    counters["steps"] = len(step_s)
    # the program's state is freed before the reference runs
    if last is not None:
        last = (program.to_host(last[0]), program.to_host(last[1]), last[2])
    captured = [program.to_host(s) for s in captured]
    del sim, prev
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    summary = None
    if trace_steps and os.path.exists(trace_path):
        from benchmark.trace import summarize

        try:
            summary = summarize(trace_path)
        finally:
            os.remove(trace_path)
        summary["rebuilt"] = rebuilt[:summary["steps"]]

    # the comparison: the first step from the harness's own initial state,
    # and the window's last step from the state the program held
    limits = load_json(os.path.join(BENCH, "limits", f"{cfg['name']}.json"))
    checks, correct = {}, failed == 0 and last is not None
    readings = {}
    t_ref = time.perf_counter()
    for tag, prev_h, out_h, row in (("first", first_in, first_out, first_row),
                                    ("last",) + (last if last is not None else (None,) * 3)):
        if prev_h is None:
            continue
        rd = check.readings(prev_h, out_h, row, cfg, ic["box"], seed, device)
        readings[tag] = rd
        ok, rows_ = check.judge(rd, limits[tag])
        correct &= ok
        for name, v, lim in rows_:
            checks[f"{tag}.{name}"] = [v, lim]
    ref_s = time.perf_counter() - t_ref
    if keep is not None:
        keep.update(readings=readings, box=ic["box"], cfg=cfg,
                    inputs={"first": first_in, "last": last[0] if last else None})
    pairs = None
    if trace_steps and captured:
        counts = [check.pair_counts(s, cfg, ic["box"], device) for s in captured]
        pairs = {k: float(np.mean([c[k] for c in counts])) for k in counts[0]}
    ctx = {"cfg": cfg, "mix": mix, "entry": entry, "n": n, "setup_s": setup_s,
           "window_s": window_s, "step_s": step_s, "dt": dts, "peak_bytes": peak,
           "counters": counters, "trace": summary, "pairs": pairs, "device": device}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec[kind]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_us"] / 1e6
        dev["window_s"] = summary["window_us"] / 1e6
        result["breakdown"] = {
            "device_ops": [[k, v / 1e6] for k, v in summary["device_ops"]],
            "idle_gaps": [[k, v / 1e6] for k, v in summary["idle_gaps"]]}
        log(f"# trace: {summary['steps']} steps, {summary['device_events']} device events, "
            f"attribution coverage {summary['coverage']:.4f}, phases (us) "
            + json.dumps({k: round(v, 1) for k, v in sorted(summary["phase_us"].items())}))
    log(f"# card: {card_line() if cuda else 'cpu'}; {n} particles; {attempted} steps in "
        f"{window_s:.3f} s; counters {json.dumps(counters)}; reference {ref_s:.1f} s; "
        f"set-up {setup_s:.2f} s")
    if len(step_s) >= 3:
        k = len(step_s) // 3
        log(f"# step ms by thirds of the window: {1e3 * np.mean(step_s[:k]):.4f} / "
            f"{1e3 * np.mean(step_s[k:len(step_s) - k]):.4f} / "
            f"{1e3 * np.mean(step_s[len(step_s) - k:]):.4f}")
    for e in errors:
        log(f"# failed: {e}")
    for tag, rd in readings.items():
        log(f"# {tag} readings: " + json.dumps({k: v for k, v in rd.items()}))
    for name, (v, lim) in checks.items():
        log(f"check {name} {v!r} limit {lim!r} {'ok' if v == v and v <= lim else 'FAIL'}")
    result["checks"] = checks
    return result
