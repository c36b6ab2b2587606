"""The port's static roofline cost layer (sphexa_torch/devtools/audit)
against the JAX package's (sphexa_tpu/devtools/audit), on the CPU.

- Probe functions, one in ``jnp`` and one in ``torch`` on the same numpy
  input from a seed: the JAX model's FLOPs of the traced jaxpr
  (``analyze_jaxpr``; a scatter by its own rule, ``_jax_flops``) and the
  port's tally of the run are equal, op rule by op rule.
- ``predict``, ``memory_bound_phases``, ``validate_budget`` and
  ``calibration_join`` on one ``CostReport`` of numbers (cpu-smoke):
  equal to the JAX functions' results.
- The whole step: the port's gather-backend std Sedov side-6 step
  (``Simulation(backend="xla")``) against the JAX registry's ``step_std``
  (the gather path on the CPU), and the ``gravity-m2p`` phase of both
  registries' ``gravity_solve``: the same phases with FLOPs, each phase's
  ratio port / JAX in [0.5, 2] but the two pinned (``PINNED``).
- The cost CLI's exit codes and JSON keys, ``trace --predict`` on the
  committed fixture (tests/torch_trace_fixture), the ``static-cost:``
  tuning objective, the kernels' bound formulas, and the tally inert.

Each registry entry is built and tallied once in the module
(``core.entry_trace``); the determinism checks add one fresh tally each.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sphexa_torch.devtools.audit import cli as tcli
from sphexa_torch.devtools.audit import costcli as tcostcli
from sphexa_torch.devtools.audit import costmodel as tc
from sphexa_torch.devtools.audit import registry as treg
from sphexa_torch.devtools.audit.core import (
    EntryPoint,
    EntryTrace,
    audit_context,
    entries_from_namespace,
    set_audit_context,
)
from sphexa_torch.devtools.audit.tally import tallying
from sphexa_torch.kernels import costs as kc
from sphexa_tpu.devtools.audit import costmodel as jc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "torch_trace_fixture")

#: phases whose port / JAX FLOP ratio cannot lie in [0.5, 2], pinned within
#: +-25% of the ratio found, and why:
#: - the gather step's ``neighbors``: the JAX search evaluates every
#:   group's window at its static cap (select_n, add, lt over W3 x cap
#:   slots) and charges its binary-search ``while`` bodies once, while the
#:   port's search gathers only the valid window slots (their count read
#:   once on the host), so the port charges 0.036 of the JAX FLOPs;
#: - ``gravity_solve``'s ``gravity-m2p``: the JAX solve maps its blocks in
#:   chunks of ``blocks_per_chunk`` (32) through ``lax.map``, so the 2
#:   target blocks of Evrard side 6 (117 particles) are padded to 32 and
#:   every M2P op is charged 16 x; the port evaluates the 2 blocks, and
#:   its softened 1/r^3 is an ``rsqrt`` (weight 4) where the JAX one is a
#:   ``pow`` (weight 8): 0.0588 of the JAX FLOPs.
PINNED = {"neighbors": 0.036, "gravity-m2p": 0.0588}


def _cpu_context():
    import dataclasses

    return dataclasses.replace(audit_context(), device="cpu")


@pytest.fixture
def cpu_audit():
    prev = set_audit_context(_cpu_context())
    yield
    set_audit_context(prev)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the entries' tensors are a few
    hundred rows, where threads only contend with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_report(case, name="case"):
    entry = EntryPoint(name=name, build=lambda: case)
    return tc.cost_report(EntryTrace(entry, case))


# -- the per-op rules, probe by probe -------------------------------------------


def _probes():
    rng = np.random.default_rng(20)
    x = rng.standard_normal(64).astype(np.float32)
    y = (rng.random(64) + 0.5).astype(np.float32)
    a = rng.standard_normal((64, 32)).astype(np.float32)
    b = rng.standard_normal((32, 16)).astype(np.float32)
    idx = rng.integers(0, 64, 32).astype(np.uint32)
    v = rng.standard_normal(32).astype(np.float32)
    # (name, jnp function, torch function, numpy inputs); the gather and
    # scatter indices are unsigned so that jnp adds no negative-index fix-up
    return [
        ("exp", jnp.exp, torch.exp, (x,)),
        ("sqrt", jnp.sqrt, torch.sqrt, (y,)),
        ("divide", lambda p, q: p / q, lambda p, q: p / q, (x, y)),
        ("where", lambda p, q: jnp.where(p > 0, p, q), lambda p, q: torch.where(p > 0, p, q),
         (x, y)),
        ("sum", jnp.sum, torch.sum, (x,)),
        ("cumsum", jnp.cumsum, lambda p: torch.cumsum(p, 0), (x,)),
        ("matmul", lambda p, q: p @ q, lambda p, q: p @ q, (a, b)),
        ("sort", jnp.sort, lambda p: torch.sort(p, stable=True).values, (x,)),
        ("scatter_add", lambda p, i, w: p.at[i].add(w),
         lambda p, i, w: p.index_add(0, i, w), (x, idx, v)),
        # a gather moves data (0 FLOPs); the add after it is charged
        ("gather", lambda p, i: p[i] + 1.0, lambda p, i: p[i] + 1.0, (x, idx)),
    ]


def _torch_arg(a):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.int64) if a.dtype == np.uint32 else t


def _jax_flops(closed) -> float:
    """The JAX cost model's FLOPs of a traced probe: ``analyze_jaxpr``'s
    total, where a scatter's combiner (``update_jaxpr``, the scalar add
    the JAX walk enters as a sub-jaxpr and charges once: 1 FLOP) counts
    by the JAX rule for the scatter itself (``eqn_flops``, its
    ``_REDUCE_PRIMS`` rule: one op per operand element), the rule the
    port's ``index_add`` / ``scatter_add`` charge. Any other probe is
    ``analyze_jaxpr``'s total as it is."""
    total = jc.analyze_jaxpr(closed).total_flops
    for eqn in closed.jaxpr.eqns:
        if eqn.primitive.name in jc._REDUCE_PRIMS and "update_jaxpr" in eqn.params:
            total += jc.eqn_flops(eqn) - jc.analyze_jaxpr(eqn.params["update_jaxpr"]).total_flops
    return total


@pytest.mark.parametrize("probe", _probes(), ids=lambda p: p[0])
def test_probe_flops_equal_jax(probe):
    name, jf, tf, args = probe
    want = _jax_flops(jax.make_jaxpr(jf)(*(jnp.asarray(a) for a in args)))
    targs = [_torch_arg(a) for a in args]
    with tallying("cpu") as t:
        tf(*targs)
    got = tc.report_from_tally(t).total_flops
    assert want > 0
    assert got == want, f"{name}: port {got} FLOPs, JAX {want}"


# -- predict, budget, calibration: equal to the JAX functions' ----------------


def _report(mod):
    rows = {
        "density": (3.2e6, {"float32": 3.2e6}, 1.1e6, 2.5e6),
        "sort": (8.0e4, {"int64": 5.0e4, "float32": 3.0e4}, 6.0e5, 1.5e6),
        "integrate": (3.0e4, {"float32": 3.0e4}, 9.8e4, 2.1e5),
        "momentum-energy": (9.7e7, {"float32": 9.7e7}, 2.0e6, 2.1e6),
        "eos": (1.5e3, {"float32": 1.5e3}, 5.2e3, 7.8e3),
    }
    phases = {p: mod.PhaseCost(phase=p, flops=f, flops_by_dtype=dict(d), hbm_lower=lo,
                               hbm_upper=up, eqns=7) for p, (f, d, lo, up) in rows.items()}
    un = mod.PhaseCost(phase="unattributed", flops=864.0, flops_by_dtype={"float32": 864.0},
                       hbm_lower=1.0e3, hbm_upper=2.0e3, eqns=2)
    total = sum(r[0] for r in rows.values()) + 864.0
    return mod.CostReport(phases=phases, unattributed=un, unknown_scopes=(),
                          total_flops=total, coverage=(total - 864.0) / total)


def _pred_dict(pred):
    return {"device": pred.device, "rows": [r.as_dict() for r in pred.rows],
            "unattributed": pred.unattributed.as_dict(), "total_ms": pred.total_ms,
            "total_ms_upper": pred.total_ms_upper, "coverage": pred.coverage,
            "unknown_scopes": list(pred.unknown_scopes)}


def test_predict_budget_calibration_equal_jax(monkeypatch):
    jp, tp = jc.predict(_report(jc), "cpu-smoke"), tc.predict(_report(tc), "cpu-smoke")
    assert _pred_dict(tp) == _pred_dict(jp)
    assert [r.as_dict() for r in tc.memory_bound_phases(tp)] == \
        [r.as_dict() for r in jc.memory_bound_phases(jp)]
    assert {r.phase for r in tc.memory_bound_phases(tp)} == {"sort", "integrate", "eos"}

    docs = [
        {"schema": 1, "device": "cpu-smoke",
         "entries": {"step_std": {"phases": {"density": 0.5}, "total_ms": 1.0}}},
        {"schema": 2, "device": "cpu-smoke", "entries": {}},
        {"schema": 1, "device": "cpu-smoke",
         "entries": {"a": {"phases": {"x": 0}}, "b": "no", "c": {"phases": {}},
                     "d": {"phases": {"y": 1.0}, "total_ms": -1}}},
        [1, 2],
    ]
    for doc in docs:
        assert tc.validate_budget(doc) == jc.validate_budget(doc)
    assert tc.validate_budget(docs[0]) == []

    summary = {"phases": [{"phase": "density", "us": 900.0}, {"phase": "sort", "us": 30.0},
                          {"phase": "momentum-energy", "us": 500000.0}]}
    calib = {"schema": 1, "target": "x.py::t", "device": "cpu-smoke", "tolerance": 2.0,
             "phases": {"density": {"ratio": 2.0}, "sort": {"ratio": 1.0},
                        "momentum-energy": {"ratio": 4.0}, "integrate": {"ratio": 1.0},
                        "gradh": {"ratio": 1.0}}}
    monkeypatch.setattr(jc, "predict_for_target", lambda target, device: jp)
    monkeypatch.setattr(tc, "predict_for_target", lambda target, device: tp)
    got, want = tc.calibration_join(summary, calib), jc.calibration_join(summary, calib)
    assert got == want
    assert not got["ok"] and {r["status"] for r in got["rows"]} == {
        "ok", "out-of-band", "no-measurement", "no-prediction"}


# -- the whole step against the JAX step ----------------------------------------


def _phase_flops(rep):
    return {p: b.flops for p, b in rep.phases.items() if b.flops > 0}


def _held(phase, ratio):
    if phase in PINNED:
        return abs(ratio / PINNED[phase] - 1.0) <= 0.25
    return 0.5 <= ratio <= 2.0


def test_step_phases_vs_jax(cpu_audit):
    """The gather-backend std step: the same phases, each ratio in the band
    or at its pin (``PINNED``: the port's search charges 0.036 of the JAX
    search, which pads every window to its static cap)."""
    from sphexa_torch.init import init_sedov
    from sphexa_torch.simulation import Simulation
    from sphexa_tpu.devtools.audit import registry as jreg
    from sphexa_tpu.devtools.audit.core import EntryTrace as JaxTrace

    jrep = jc.cost_report(JaxTrace(jreg.step_std, jreg.step_std.build()))
    state, box, const = init_sedov(6, device="cpu")
    sim = Simulation(state, box, const, prop="std", device="cpu", backend="xla")
    trep = _port_report(treg._step_case(sim))
    jf, tf = _phase_flops(jrep), _phase_flops(trep)
    assert set(tf) == set(jf)
    ratios = {p: tf[p] / jf[p] for p in jf}
    bad = {p: r for p, r in ratios.items() if not _held(p, r)}
    assert not bad, f"port / JAX FLOPs out of band: {bad} (all {ratios})"
    assert trep.kernels == {}  # the gather backend launches no kernel


def test_gravity_m2p_vs_jax(cpu_audit):
    """``gravity_solve``'s far field, plain array code on both sides: the
    port at its pin (``PINNED``: the JAX solve pads its 2 blocks to a
    chunk of 32)."""
    from sphexa_tpu.devtools.audit import registry as jreg
    from sphexa_tpu.devtools.audit.core import EntryTrace as JaxTrace

    jrep = jc.cost_report(JaxTrace(jreg.gravity_solve, jreg.gravity_solve.build()))
    trep = _port_report(treg.gravity_solve.build())
    ratio = trep.phases["gravity-m2p"].flops / jrep.phases["gravity-m2p"].flops
    assert _held("gravity-m2p", ratio), ratio
    assert trep.kernels == {"gravity_p2p": 1, "compact_class_lists": 1}


# -- the cost CLI ---------------------------------------------------------------


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cost_cli_exit_codes(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    rc, out = _run(tcli.main, ["cost", "--cpu", "--entries", "step_std,observable_snapshot"],
                   capsys)
    assert rc == 0, out
    assert "step_std" in out and "momentum-energy" in out and "torchcost: 0 finding" in out
    # a budget below the prediction: a JXA302 finding
    low = tmp_path / "budget.json"
    low.write_text(json.dumps({"schema": 1, "device": "h100", "entries": {
        "step_std": {"phases": {"momentum-energy": 1e-12}}}}))
    rc, out = _run(tcli.main, ["cost", "--cpu", "--entries", "step_std", "--budget",
                               str(low)], capsys)
    assert rc == 1 and "JXA302" in out
    # an unknown device or entry, a mesh of one rank: usage errors
    for argv in (["cost", "--cpu", "--device", "v5e"], ["cost", "--cpu", "--entries", "nope"],
                 ["preflight", "--mesh", "1"]):
        assert tcli.main(argv) == 2, argv
    rc, out = _run(tcli.main, ["--list-rules"], capsys)
    assert rc == 0 and {"JXA301", "JXA302", "JXA303"} <= {ln.split()[0] for ln in
                                                          out.splitlines()}
    rc, out = _run(tcli.main, ["--list-entries"], capsys)
    names = {ln.split()[0] for ln in out.splitlines()}
    assert rc == 0 and names == {"step_std", "step_ve", "step_nbody", "step_turb_ve",
                                 "step_std_cooling", "gravity_solve", "step_std_blockdt",
                                 "observable_ledger", "observable_snapshot", "step_std_lists",
                                 "step_ve_lists", "knob_inertness", "halo_exchange_sparse",
                                 "halo_exchange_windowed", "gravity_sharded",
                                 "gravity_sharded_windowed", "step_std_sharded",
                                 "step_std_blockdt_sharded", "observable_ledger_sharded",
                                 "observable_snapshot_sharded", "tree_build_sizing"}
    if not torch.cuda.is_available():
        for argv in (["cost"], [], ["lowering"], ["schema"]):
            assert tcli.main(argv) == 2, argv  # the card unless --cpu


def test_cost_cli_json_keys_match_jax(capsys, monkeypatch):
    from sphexa_tpu.devtools.audit import costcli as jcostcli

    monkeypatch.chdir(ROOT)
    rc, out = _run(jcostcli.main, ["--json", "--cpu-devices", "0", "--entries",
                                   "observable_snapshot"], capsys)
    assert rc == 0
    want = json.loads(out)
    rc, out = _run(tcostcli.main, ["--json", "--cpu", "--entries", "observable_snapshot"],
                   capsys)
    assert rc == 0
    got = json.loads(out)
    assert set(got) == set(want)
    (ge,), (we,) = got["entries"], want["entries"]
    assert set(ge) == set(we)
    assert set(ge["unattributed"]) == set(we["unattributed"])
    assert set(ge["phases"][0]) == set(we["phases"][0])
    assert [p["phase"] for p in ge["phases"]] == [p["phase"] for p in we["phases"]]


def test_committed_budget_holds(capsys, monkeypatch):
    """COST_BUDGET_TORCH.json: schema 1, h100, the JAX budget's six
    entries, every ceiling above the committed tree's prediction."""
    monkeypatch.chdir(ROOT)
    doc = tc.load_budget(os.path.join(ROOT, "COST_BUDGET_TORCH.json"))
    with open(os.path.join(ROOT, "COST_BUDGET.json")) as f:
        jax_budget = json.load(f)
    assert doc["device"] == "h100" and set(doc["entries"]) == set(jax_budget["entries"])
    rc, out = _run(tcostcli.main, ["--cpu", "--entries", ",".join(doc["entries"])], capsys)
    assert rc == 0, out


def _second_tally(entry):
    """A fresh build and run of ``entry`` (the process's first is cached)."""
    trace = EntryTrace(entry, entry.build())
    tc.cost_report(trace)
    return trace


def test_registry_coverage_and_determinism(cpu_audit):
    """Every registry entry builds and runs on the CPU, at or above its
    JXA301 floor (a sharded entry on each of its two ranks), and two
    tallies of a one-device entry are equal: the same costs and the same
    record (the lowering lock's fingerprint, its alpha-stability contract;
    a sharded entry's records are held to the lock, written by another
    process, in tests/test_torch_audit.py)."""
    from sphexa_torch.devtools.audit.core import run_sharded
    from sphexa_torch.devtools.audit.lowerdiff import lowering_fingerprint
    from sphexa_torch.kernels.cost_checks import COMPARED, tally_entry

    run_sharded(entries_from_namespace(vars(treg)), "cpu")  # one spawn for the nine
    for entry in entries_from_namespace(vars(treg)):
        if entry.mesh_axes:
            for view in tally_entry(entry, "cpu").ranks:
                rep = tc.cost_report(view)
                floor = entry.phase_coverage_min
                floor = audit_context().phase_coverage_min if floor is None else floor
                assert rep.coverage >= floor and not rep.unknown_scopes, (entry.name,
                                                                          rep.coverage)
            continue
        a, b = tally_entry(entry, "cpu"), _second_tally(entry)
        ra, rb = tc.cost_report(a), tc.cost_report(b)
        floor = entry.phase_coverage_min
        floor = audit_context().phase_coverage_min if floor is None else floor
        assert ra.coverage >= floor, (entry.name, ra.coverage)
        assert not ra.unknown_scopes
        assert set(ra.phases) == set(rb.phases) and ra.kernels == rb.kernels
        for p in ra.phases:
            for k in COMPARED:
                assert getattr(ra.phases[p], k) == getattr(rb.phases[p], k), (entry.name, p, k)
        fa, fb = lowering_fingerprint(a), lowering_fingerprint(b)
        assert fa.lock_payload() == fb.lock_payload(), entry.name


# -- trace --predict on the committed fixture ------------------------------------


def test_fixture_predict(tmp_path, capsys, monkeypatch):
    from sphexa_torch.telemetry import cli as telcli

    monkeypatch.chdir(ROOT)
    rc, out = _run(telcli.main, ["trace", FIXTURE, "--predict", "--format", "json"], capsys)
    assert rc == 0, out
    joined = json.loads(out)["calibration"]
    assert joined["ok"] and joined["device"] == "cpu-smoke" and len(joined["rows"]) >= 5
    # a corrupted rule leaves the band
    monkeypatch.setitem(tc.ELEMENTWISE_WEIGHTS, "mul", 100.0)
    rc, out = _run(telcli.main, ["trace", FIXTURE, "--predict", "--format", "json"], capsys)
    assert rc == 1
    assert json.loads(out)["calibration"]["violations"]
    monkeypatch.undo()
    # no calibration declaration: a usage error
    bare = tmp_path / "bare"
    bare.mkdir()
    for f in os.listdir(FIXTURE):
        if f != tc.CALIBRATION_FILE:
            shutil.copy(os.path.join(FIXTURE, f), bare / f)
    monkeypatch.chdir(ROOT)
    assert telcli.main(["trace", str(bare), "--predict"]) == 2
    assert telcli.main(["trace", str(bare)]) == 0


def test_fixture_size_and_target():
    with open(os.path.join(FIXTURE, tc.CALIBRATION_FILE)) as f:
        calib = json.load(f)
    assert calib["target"] == "scripts/make_torch_trace_fixture.py::trace_fixture"
    assert calib["device"] == "cpu-smoke" and calib["tolerance"] == 2.0
    size = sum(os.path.getsize(os.path.join(FIXTURE, f)) for f in os.listdir(FIXTURE))
    assert size < 200_000


# -- the static-cost: tuning objective -------------------------------------------


def test_static_cost_objective(tmp_path):
    from sphexa_torch.telemetry import validate_event
    from sphexa_torch.tuning import ReplaySpec, static_cost_candidate
    from sphexa_torch.tuning import cli as tune_cli

    spec = ReplaySpec(case="sedov", side=6, device="cpu")
    recs = [static_cost_candidate(spec, k, "density") for k in ({}, {"cell_target": 64})]
    for r in recs:
        assert r["status"] == "ok" and r["objective"] == "static-cost:density"
        assert r["value"] == r["predicted_ms"] > 0
        assert r["bound"] in ("compute", "memory", "ici") and r["device"] == "h100"
        assert r["steps"] == 0
    with pytest.raises(ValueError):
        static_cost_candidate(spec, {}, "warpdrive")
    out = tmp_path / "sweep"
    rc = tune_cli.main(["--device", "cpu", "--case", "sedov", "--side", "6", "--knobs",
                        "cell_target", "--budget", "2", "--objective", "static-cost:density",
                        "--out", str(out), "--quiet"])
    assert rc == 0
    events = [json.loads(ln) for ln in (out / "events.jsonl").read_text().splitlines()]
    sweeps = [e for e in events if e.get("kind") == "sweep"]
    assert len(sweeps) == 2
    for e in sweeps:
        assert validate_event(e) == [] and e["status"] == "ok"
        assert e["objective"] == "static-cost:density" and e["value"] > 0
    assert tune_cli.main(["--device", "cpu", "--case", "sedov", "--side", "6",
                          "--objective", "static-cost:density", "--cost-device", "v5e",
                          "--out", str(out)]) == 2


# -- the kernels' bound formulas (PERF.md's kernel table) ------------------------


def _bound_ms(ops, nbytes, int_ops=0):
    return 1e3 * max(ops / 67e12 + int_ops / 33.5e12, nbytes / 3.35e12)


class _Ranges:
    def __init__(self, lens):
        self.lens = torch.tensor(lens, dtype=torch.int32)
        self.starts = torch.zeros_like(self.lens)


class _Lists:
    def __init__(self, cnt, words, ranges):
        self.cnt = torch.tensor(cnt, dtype=torch.int32)
        self.word_off = torch.tensor([0, words], dtype=torch.int32)
        self.ranges = ranges


def test_kernel_bound_formulas():
    """Fixed counts through the bound helpers moved from chip_smoke.py:
    operations and bytes by the formulas PERF.md quotes (the mask 12 per
    candidate pair, the symmetric cutoff 2 per neighbour pair, the bodies
    per pair; each array once), bound = max(ops / 67 TFLOP/s, bytes / 3.35
    TB/s)."""
    assert kc.PEAK_FP32_FLOPS == 67e12 and kc.PEAK_HBM_BYTES == 3.35e12
    assert kc.PEAK_INT32_OPS == 33.5e12
    assert kc.LANES == _pe().LANES
    b = kc._bound(6.7e9, 1.0)
    assert b["bound_ms"] == pytest.approx(0.1, rel=1e-12) and b["bound_by"] == "operations"
    assert kc._bound(1.0, 3.35e9)["bound_by"] == "bytes"
    r = _Ranges([[1, 2, 3], [4, 0, 0]])  # 10 candidate runs, 2 groups x 3 cells
    out = kc.bounds(r, 128, 64, 1000, ops=("density", "momentum_energy_std"),
                    pairs={"momentum_energy_std": {"pairs": 800}})
    tables = 4 * (5 * 2 * 3 + 2)
    want = {"density": (640 * 12 + 1000 * 32, 4 * 128 * 8 + tables),
            "momentum_energy_std": (640 * 12 + 2 * 1000 + 800 * 156, 4 * 128 * 26 + tables)}
    for op, (ops, nbytes) in want.items():
        assert (out[op]["ops"], out[op]["bytes"]) == (ops, nbytes)
        assert out[op]["bound_ms"] == pytest.approx(_bound_ms(ops, nbytes), rel=1e-12)
        assert out[op]["cand_pairs"] == 640
    # wendland-c6: 12 more operations per polynomial evaluation
    assert kc.body_ops("density", "density", 1000, ncoef=20) == 1000 * (32 + 12)
    # the list walk: density writes its mask words, IAD reads them
    lists = _Lists([[10, 20], [30, 0]], 5, r)
    lb = kc.list_bounds(lists, 128, 64, 1000, walk_ops=("density_lists", "iad_lists"))
    lanes, ng, scap = 60, 2, 2
    io_t = 4 * (5 * ng * scap + ng) + 16 * ng * scap
    words = 4 * 5 * 64
    d_ops = lanes * 3 + 1000 * 32 + lanes * 64 * 9
    assert (lb["density_lists"]["ops"], lb["density_lists"]["bytes"]) == (
        d_ops, 4 * 128 * 8 + io_t + words)
    i_ops = lanes * 3 + 1000 * 50 + 1000 * 8
    assert (lb["iad_lists"]["ops"], lb["iad_lists"]["bytes"]) == (
        i_ops, 4 * 128 * 12 + io_t + words)
    # the charge of a walk equals its bound's counts in its mask mode
    assert kc.pair_cost(_spec("iad"), r, [torch.zeros(128)], [torch.zeros(128)],
                        {"coeffs": (0.0,) * 14}, 64, lists=lists, mask="read",
                        nb_pairs=1000) == (i_ops, 4 * 128 * 12 + io_t + words)
    # the list build: cull tables, rows, the pruned tables; FP32 and INT32
    mb = kc.mark_bound(128, 2, 27, 4, 1024)
    int_ops = 2 * 27 * (np.log2(27) + 8) + 1024 // 128 * 8
    assert mb["bytes"] == 29 * 2 * 27 + 16 * 128 + 4 + 40 * 2 * 4 + 16
    assert mb["int_ops"] == pytest.approx(int_ops)
    assert mb["ops"] == pytest.approx(1024 * 11 + 2 * int_ops)
    # the near field and the compaction
    g = kc.gravity_bounds(torch.tensor([[3, 4], [5, 0]], dtype=torch.int32), 100, 64,
                          [(torch.zeros(2, 100, dtype=torch.int32), 8, 9)])
    assert (g["gravity_p2p"]["ops"], g["gravity_p2p"]["bytes"]) == (
        12 * 64 * 25, 4 * 100 * 9 + 2 * 4 * 4 + 4 * 2)
    k13 = g["compact_class_lists"]
    assert (k13["ops"], k13["bytes"]) == (200 * 10, 4 * 200 + 4 * 2 * 19)
    assert k13["bound_ms"] == pytest.approx(_bound_ms(0, 4 * 200 + 152, 2000), rel=1e-12)
    jd = kc.p2p_jdata_bound(torch.tensor([[3, 4], [5, 0]], dtype=torch.int32), 100, 150, 64)
    assert (jd["ops"], jd["bytes"]) == (12 * 64 * 25, 4 * 100 * 8 + 4 * 150 * 5 + 32 + 8)
    assert kc.compact_row_cost(1000) == (4000, 5004)


def _pe():
    from sphexa_torch.sph import pair_engine as pe

    return pe


def _spec(name):
    return {"iad": _pe().IAD, "density": _pe().DENSITY}[name]


@pytest.mark.parametrize("name,prop", [("step_std_lists", "std"), ("step_ve_lists", "ve")])
def test_list_mode_case_tally(name, prop, cpu_audit):
    """The list-mode cases of kernels/cost_checks.py (Noh side 12, whose
    grid does not fold; the card holds them to this CPU tally): K5 and each
    of the prop's walks charged once, two tallies equal, coverage at
    JXA301's floor, and each walk's charge equal to ``list_bounds``' formula
    for its mask mode (density writes its mask words, the later walks read
    them) at the charge's own counts."""
    from sphexa_torch.kernels import cost_checks as cc

    entry = {e.name: e for e in cc.LIST_ENTRIES}[name]
    a, b = cc.tally_entry(entry, "cpu"), _second_tally(entry)
    ra, rb = tc.cost_report(a), tc.cost_report(b)
    assert dict(ra.kernels) == {k: 1 for k in cc.LIST_KERNELS[name]}
    assert ra.coverage >= audit_context().phase_coverage_min and not ra.unknown_scopes
    assert set(ra.phases) == set(rb.phases) and ra.kernels == rb.kernels
    for p in ra.phases:
        for k in cc.COMPARED:
            assert getattr(ra.phases[p], k) == getattr(rb.phases[p], k), (p, k)
    sim = treg._sim("noh", cc.LIST_SIDE, prop, "cpu")
    logs = {k[1]: k for k in a.tally.kernel_log}
    walks = sorted(cc.LIST_KERNELS[name] - {"mark"})
    nb = logs["density_lists"][4]["nb_pairs"]
    assert nb > 0 and all(logs[w][4]["nb_pairs"] == nb for w in walks)
    pairs = {w: logs[w][4]["pairs"] for w in walks if logs[w][4]["pairs"] is not None}
    assert set(pairs) == {w for w in walks if w.startswith("momentum")}
    n = sim.sim_state.particles.x.shape[0]
    lb = kc.list_bounds(sim.lists, n, sim.cfg.nbr.group, nb, walk_ops=walks, pairs=pairs)
    for w in walks:
        assert (logs[w][2], logs[w][3]) == (lb[w]["ops"], lb[w]["bytes"]), w


# -- the tally is inert ----------------------------------------------------------

_STEP = r"""
import sys
import numpy as np
from sphexa_torch.devtools.audit.registry import _sim, _step_case
from sphexa_torch.sph.pair_engine import LAUNCHES
sim = _sim("sedov", 6, "std", "cpu")
case = _step_case(sim)
out, _ = case.fn(*case.args)
assert "sphexa_torch.devtools.audit.tally" not in sys.modules
p = out.particles
np.savez(sys.argv[1], launches=np.array(sorted(LAUNCHES.items()), dtype=object),
         **{k: getattr(p, k).numpy() for k in ("x", "y", "z", "vx", "h", "temp", "du")})
"""


def test_tally_inert(tmp_path, cpu_audit):
    """A CPU step's outputs and LAUNCHES bit for bit the same in a process
    that never imported the tally, under a tally, and after one."""
    from sphexa_torch.sph.pair_engine import LAUNCHES

    path = str(tmp_path / "ref.npz")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", _STEP, path], check=True, cwd=ROOT, env=env,
                   timeout=300)
    ref = np.load(path, allow_pickle=True)
    case = treg._step_case(treg._sim("sedov", 6, "std", "cpu"))
    with tallying("cpu") as t:
        tallied, _ = case.fn(*case.args)
    assert t.kernels and t.acc.buckets
    after, _ = case.fn(*case.args)
    for out in (tallied, after):
        for k in ("x", "y", "z", "vx", "h", "temp", "du"):
            assert np.array_equal(getattr(out.particles, k).numpy(), ref[k]), k
    assert sorted(LAUNCHES.items()) == [tuple(r) for r in ref["launches"]]
