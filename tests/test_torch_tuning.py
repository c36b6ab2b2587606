"""The port's tuning package (sphexa_torch/tuning) against the JAX
package's (sphexa_tpu/tuning), on the CPU.

- the registry: the JAX registry less exactly {donate, blocks_per_chunk},
  spec for spec; a renamed owner field, or a sentinel knob the
  constructor no longer consumes, raises;
- the pure functions (``n_bucket``, ``validate_table``, ``resolve_entry``,
  ``resolve_knobs`` with all four sources and the precedence,
  ``coverage``) on numpy-seeded tables: equal, the table path of the
  provenance aside;
- ``run_sweep`` under one seeded fake measurement with failures and
  overflows: the same history, best and candidate count;
- ``Simulation(tuned=...)`` on the gather backend (both packages'
  ``backend="xla"``): the same neighbour and gravity config fields, and
  steps within tests/test_torch_gather_slice.py's tolerances;
- untuned runs: ``tuned=None`` and every off sentinel leave the config
  and the steps bit for bit as they are without ``tuned``;
- the replay: ``spec_from_manifest`` of the port CLI's run dir equals the
  JAX result on the JAX CLI's run dir for the same argv;
- a micro sweep through ``python -m sphexa_torch.tuning``'s entry point:
  schema-valid ``sweep`` events and a table the port validates.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import sphexa_tpu.tuning as jt
from sphexa_tpu.app import main as jax_app
from sphexa_tpu.init import init_evrard as jax_init_evrard
from sphexa_tpu.init import init_sedov as jax_init_sedov
from sphexa_tpu.simulation import Simulation as JaxSimulation
from sphexa_tpu.tuning import knobs as jknobs
from sphexa_tpu.tuning import search as jsearch
from sphexa_tpu.tuning import table as jtable

import sphexa_torch.tuning as tt
from sphexa_torch import simulation as tsim
from sphexa_torch.app import main as app
from sphexa_torch.init import init_evrard, init_sedov
from sphexa_torch.telemetry.registry import validate_event
from sphexa_torch.tuning import cli as tcli
from sphexa_torch.tuning import knobs as tknobs
from sphexa_torch.tuning import search as tsearch
from sphexa_torch.tuning import table as ttable

#: the JAX knobs the port has no counterpart of
LEFT_OUT = {"donate", "blocks_per_chunk"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier 1 runs several test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the registry -------------------------------------------------------------


def test_registry_is_the_jax_registry_less_two():
    assert set(jknobs.KNOBS) - set(tknobs.KNOBS) == LEFT_OUT
    assert set(tknobs.KNOBS) <= set(jknobs.KNOBS)
    assert list(tknobs.KNOBS) == [k for k in jknobs.KNOBS if k not in LEFT_OUT]
    for name, t in tknobs.KNOBS.items():
        j = jknobs.KNOBS[name]
        for f in ("name", "owner", "field", "domain", "cost", "description"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert t.has_off_sentinel == j.has_off_sentinel, name
        if j.has_off_sentinel:
            assert t.off_sentinel == j.off_sentinel and \
                type(t.off_sentinel) is type(j.off_sentinel), name
    for group in ("GRAVITY_KNOBS", "NEIGHBOR_KNOBS", "SIMULATION_KNOBS", "BLOCKDT_KNOBS"):
        assert getattr(tknobs, group) == tuple(
            k for k in getattr(jknobs, group) if k not in LEFT_OUT), group
    assert set(tsim.CONSUMED_KNOBS) == set(jt_consumed()) - LEFT_OUT
    tknobs.validate_registry()


def jt_consumed():
    from sphexa_tpu import simulation as jsim

    return jsim.CONSUMED_KNOBS


@pytest.mark.parametrize("owner", ["GravityConfig", "NeighborConfig", "PropagatorConfig",
                                   "make_propagator_config", "Simulation"])
def test_renamed_owner_field_raises(owner, monkeypatch):
    name = next(k for k, s in tknobs.KNOBS.items() if s.owner == owner)
    bad = dataclasses.replace(tknobs.KNOBS[name], field=name + "_renamed")
    monkeypatch.setitem(tknobs.KNOBS, name, bad)
    with pytest.raises(RuntimeError, match=f"{owner}.{name}_renamed"):
        tknobs.validate_registry()


def test_unconsumed_off_sentinel_raises(monkeypatch):
    monkeypatch.setattr(tsim, "CONSUMED_KNOBS",
                        tuple(k for k in tsim.CONSUMED_KNOBS if k != "grav_window"))
    with pytest.raises(RuntimeError, match="grav_window"):
        tknobs.validate_registry()


# -- the pure functions -------------------------------------------------------


WORKLOADS = ("sedov", "evrard", "noh", "generic")
BACKENDS = ("pallas", "xla")


def _random_knobs(rng):
    names = [k for k in tknobs.KNOBS if k not in ("dt_bins",)]
    pick = rng.choice(len(names), size=int(rng.integers(1, 4)), replace=False)
    return {names[i]: tknobs.KNOBS[names[i]].domain[int(rng.integers(
        len(tknobs.KNOBS[names[i]].domain)))] for i in sorted(pick)}


def _random_table(rng, entries: int = 8):
    table = {"schema": 1, "entries": []}
    for _ in range(entries):
        n = int(10 ** rng.uniform(2, 7))
        e = ttable.make_entry(str(rng.choice(WORKLOADS)), n, int(rng.choice([1, 2, 4])),
                              str(rng.choice(BACKENDS)), _random_knobs(rng),
                              {"created": "2026-01-01", "objective": "per_step_s",
                               "win": float(rng.uniform(0, 0.5))})
        ttable.upsert_entry(table, e)
    return table


def _broken_tables(rng):
    good = _random_table(rng, 4)
    stale = json.loads(json.dumps(good))
    stale["entries"][0]["knobs"]["no_such_knob"] = 1
    dup = json.loads(json.dumps(good))
    dup["entries"].append(dict(dup["entries"][0]))
    missing = json.loads(json.dumps(good))
    del missing["entries"][1]["p"]
    noprov = json.loads(json.dumps(good))
    del noprov["entries"][2]["provenance"]
    empty = json.loads(json.dumps(good))
    empty["entries"][3]["knobs"] = {}
    donate = json.loads(json.dumps(good))
    donate["entries"][0]["knobs"]["blocks_per_chunk"] = 8
    return [good, stale, dup, missing, noprov, empty, donate, {"schema": 2, "entries": []},
            {"schema": 1, "entries": {}}, [], {"schema": 1, "entries": [3]}]


def test_n_bucket_matches_jax():
    rng = np.random.default_rng(19)
    for n in list(rng.integers(0, 10 ** 8, size=200)) + [0, 1, 9, 10, 99_999, 100_000]:
        assert ttable.n_bucket(int(n)) == jtable.n_bucket(int(n))


def test_validate_table_matches_jax():
    rng = np.random.default_rng(7)
    tables = _broken_tables(rng)
    for t in tables:
        got = ttable.validate_table(t)
        want = jtable.validate_table(t)
        # the port's registry lacks two JAX knobs: a table naming them is stale here
        if isinstance(t, dict) and any(
                isinstance(e, dict) and set(e.get("knobs") or {}) & LEFT_OUT
                for e in t.get("entries") or []):
            assert any("blocks_per_chunk" in p for p in got) and got != want
            continue
        assert got == want
    assert ttable.validate_table(tables[0]) == []
    assert all(ttable.validate_table(t) for t in tables[1:])


def test_resolve_entry_and_coverage_match_jax():
    rng = np.random.default_rng(11)
    for _ in range(5):
        table = _random_table(rng)
        assert ttable.coverage(table) == jtable.coverage(table)
        for _ in range(40):
            args = (str(rng.choice(WORKLOADS)), int(10 ** rng.uniform(2, 7)),
                    int(rng.choice([1, 2, 4])), str(rng.choice(BACKENDS)))
            assert ttable.resolve_entry(table, *args) == jtable.resolve_entry(table, *args)
        for e in table["entries"]:
            key = (e["workload"], int(float(e["n_bucket"])), e["p"], e["backend"])
            assert ttable.resolve_entry(table, *key) is e


def test_resolve_knobs_matches_jax(tmp_path, monkeypatch):
    """All four sources (None, "auto", a table path or dict, a knob dict)
    and the precedence explicit > table > default; with "auto" both
    packages read the same file (each through its own variable)."""
    rng = np.random.default_rng(3)
    table = _random_table(rng, 10)
    path = str(tmp_path / "table.json")
    ttable.save_table(path, table)
    monkeypatch.setenv(ttable.TABLE_ENV, path)
    monkeypatch.setenv(jtable.TABLE_ENV, path)
    e = table["entries"][0]
    key = dict(workload=e["workload"], n=int(float(e["n_bucket"])), p=e["p"],
               backend=e["backend"])
    some = next(iter(e["knobs"]))
    cases = []
    for tuned in (None, "auto", path, table, _random_knobs(rng)):
        for explicit in ({}, {some: e["knobs"][some]}, {"check_every": 8}):
            cases.append((tuned, key, explicit))
            cases.append((tuned, dict(key, workload="unknown"), explicit))
    for tuned, k, explicit in cases:
        got = ttable.resolve_knobs(tuned, explicit=explicit, **k)
        want = jtable.resolve_knobs(tuned, explicit=explicit, **k)
        assert got == want, (tuned if not isinstance(tuned, dict) else "dict", k, explicit)
    # the sources, as the provenance names them
    src = {t if isinstance(t, str) else type(t).__name__:
           ttable.resolve_knobs(t, explicit={}, **key)[1]["source"]
           for t in ("auto", path, {"gap": 128})}
    assert src == {"auto": "table", path: "table", "dict": "direct"}
    assert ttable.resolve_knobs(None, explicit={}, **key)[1]["source"] == "heuristic"
    ov, prov = ttable.resolve_knobs(table, explicit={some: 1}, **key)
    assert some not in ov and prov["explicit"] == [some]
    with pytest.raises(ValueError, match="unregistered"):
        ttable.resolve_knobs({"donate": True}, explicit={}, **key)
    monkeypatch.delenv(ttable.TABLE_ENV)
    assert ttable.default_table_path().endswith("TUNING_TABLE_TORCH.json")
    assert ttable.load_table() == ttable.new_table()  # committed empty


# -- the sweep driver ---------------------------------------------------------


def test_run_sweep_matches_jax():
    """One seeded fake measurement, with failures (raises) and overflows,
    through both drivers: the same history, best and candidate count."""
    names = ["cell_target", "gap", "group", "list_skin_rel"]

    def fake(seed):
        rng = np.random.default_rng(seed)
        table = {}

        def measure(knobs):
            key = json.dumps(knobs, sort_keys=True)
            if key not in table:
                table[key] = (float(rng.uniform()), float(rng.uniform(1.0, 2.0)))
            u, v = table[key]
            if knobs and u < 0.15:
                raise ValueError(f"dead candidate {key}")
            return {"status": "overflow" if knobs and u < 0.3 else "ok", "value": v}
        return measure

    for seed in range(6):
        for budget in (1, 4, 9, 20):
            tr = tsearch.run_sweep(fake(seed), tsearch.domains_for(names), budget)
            jr = jsearch.run_sweep(fake(seed), jsearch.domains_for(names), budget)
            assert tr == jr, (seed, budget)
    with pytest.raises(KeyError):
        tsearch.domains_for(["donate"])


# -- Simulation(tuned=...) ----------------------------------------------------

#: name -> (JAX init, port init, side, Simulation keywords, tuned knob dict)
TUNED = {
    "sedov_neighbours": (jax_init_sedov, init_sedov, 10, {},
                         {"cell_target": 64, "gap": 128, "group": 32, "run_cap": 1024}),
    "evrard_gravity": (jax_init_evrard, init_evrard, 12, {},
                       {"target_block": 128, "super_factor": 4, "gap": 512}),
}


@pytest.mark.parametrize("name", list(TUNED))
def test_tuned_simulation_matches_jax(name):
    jinit, tinit, side, kw, knobs = TUNED[name]
    jsim = JaxSimulation(*jinit(side), backend="xla", tuned=knobs,
                         workload="sedov", **kw)
    sim = tsim.Simulation(*tinit(side, device="cpu"), device="cpu", backend="xla",
                          tuned=knobs, workload="sedov", **kw)
    assert sim.tuning_provenance == jsim.tuning_provenance
    jn, tn = jsim._cfg.nbr, sim.cfg.nbr
    for f in ("level", "cap", "group", "window", "run_cap", "gap", "block", "ngmax"):
        assert getattr(tn, f) == getattr(jn, f), f
    if "target_block" in knobs:
        jg, tg = jsim._cfg.gravity, sim.cfg.gravity
        for f in ("target_block", "super_factor", "compaction", "m2p_cap", "p2p_cap",
                  "leaf_cap"):
            assert getattr(tg, f) == getattr(jg, f), f
        assert tg.target_block == 128 and tg.super_factor == 4 and tg.compaction == "sort"
    jd = [jsim.step() for _ in range(2)]
    td = [sim.step() for _ in range(2)]
    for t, j in zip(td, jd):
        for k in ("nc_max", "occupancy", "m2p_max", "p2p_max", "leaf_occ"):
            if k in j:
                assert float(t[k]) == float(j[k]), k
        for k in ("dt", "nc_mean", "egrav"):
            if k in j:
                assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-6), k
    s0, s1 = jsim.state, sim.state
    for f in dataclasses.fields(s0):
        a, b = getattr(s1, f.name).numpy(), np.asarray(getattr(s0, f.name))
        if f.name == "h":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg="h")
            continue
        ref = np.asarray(s0.temp) if f.name == "temp_lo" else b
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=5e-6 * float(np.max(np.abs(ref))),
                                   err_msg=f.name)


def test_tuned_gravity_knobs_on_the_engine():
    """On the engine backend a tuned super_factor > 0 takes the bitmask
    compaction (K13's two-level form), 0 the sort, over gravity_tuning's
    shape; the table's entry reaches the solver through a file."""
    st, box, const = init_evrard(12, device="cpu")
    for sf, comp in ((4, "bitmask"), (16, "bitmask"), (0, "sort")):
        sim = tsim.Simulation(st, box, const, device="cpu", prop="ve",
                              tuned={"target_block": 256, "super_factor": sf})
        g = sim.cfg.gravity
        assert (g.target_block, g.super_factor, g.compaction) == (256, sf, comp)
    sim.step()
    ref = tsim.Simulation(st, box, const, device="cpu", prop="ve")
    assert (ref.cfg.gravity.target_block, ref.cfg.gravity.compaction) == (64, "sort")


def _equal_states(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x, y), f.name


def test_untuned_and_off_sentinels_change_nothing():
    """``tuned=None`` and ``tuned={knob: off}`` for every off-sentinel knob
    give the config of a run without ``tuned`` and the same steps bit for
    bit (std Sedov 10 on the engine, lists on)."""
    st, box, const = init_sedov(10, device="cpu")
    ref = tsim.Simulation(st, box, const, device="cpu")
    for _ in range(2):
        ref.step()
    offs = [{}] + [{s.name: s.off_sentinel} for s in tknobs.off_sentinel_knobs()]
    assert {k for o in offs for k in o} == {"super_factor", "check_every", "grav_window",
                                           "dt_bins", "bin_sync_every", "bin_resort_drift"}
    for tuned in [None] + offs[1:]:
        sim = tsim.Simulation(st, box, const, device="cpu", tuned=tuned)
        assert sim.cfg == tsim.Simulation(st, box, const, device="cpu").cfg, tuned
        for _ in range(2):
            sim.step()
        _equal_states(sim.state, ref.state)
        assert sim.cfg == ref.cfg and sim.rebuilds == ref.rebuilds, tuned
    cfg = tsim.make_propagator_config(st, box, const, tuned={"gap": 128, "group": 32})
    assert (cfg.nbr.gap, cfg.nbr.group) == (128, 32)
    assert tsim.make_propagator_config(st, box, const, tuned={"gap": 128}, gap=512).nbr.gap \
        == 512
    assert tsim.make_propagator_config(st, box, const, tuned=None) == \
        tsim.make_propagator_config(st, box, const)


def test_table_entry_beats_default_and_loses_to_a_keyword(tmp_path):
    st, box, const = init_sedov(10, device="cpu")
    table = ttable.new_table()
    ttable.upsert_entry(table, ttable.make_entry(
        "sedov", st.n, 1, "pallas", {"check_every": 4, "group": 32, "list_skin_rel": 0.3},
        {"created": "2026-01-01"}))
    path = str(tmp_path / "t.json")
    ttable.save_table(path, table)
    sim = tsim.Simulation(st, box, const, device="cpu", tuned=path, workload="sedov",
                          check_every=2)
    assert sim.check_every == 2 and sim.cfg.nbr.group == 32
    assert sim.cfg.list_skin_rel == 0.3
    assert sim.tuning_provenance["source"] == "table"
    assert sim.tuning_provenance["explicit"] == ["check_every"]
    miss = tsim.Simulation(st, box, const, device="cpu", tuned=path, workload="noh")
    assert miss.tuning_provenance["source"] == "heuristic" and miss.cfg.nbr.group == 64


# -- the replay harness and the sweep CLI --------------------------------------


def test_spec_from_manifest_matches_jax(tmp_path):
    argv = ["--init", "sedov", "-n", "8", "-s", "1", "--cpu-mesh", "--backend", "xla",
            "--theta", "0.6", "--quiet"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jax_app.main(argv + ["-o", jdir, "--telemetry-dir", jdir]) == 0
    assert app.main(argv + ["-o", tdir, "--telemetry-dir", tdir]) == 0
    js, ts = jt.spec_from_manifest(jdir), tt.spec_from_manifest(tdir)
    for f in dataclasses.fields(js):
        assert getattr(ts, f.name) == getattr(js, f.name), f.name
    assert ts.device == "cpu" and ts.n == js.n
    with open(os.path.join(tdir, "manifest.json")) as f:
        stamp = json.load(f)["tuning"]
    with open(os.path.join(jdir, "manifest.json")) as f:
        assert stamp == json.load(f)["tuning"]
    with pytest.raises(FileNotFoundError):
        tt.spec_from_manifest(str(tmp_path))
    # the replayed spec scores by the static roofline objective too
    r = tt.static_cost_candidate(ts, {}, "density")
    assert r["status"] == "ok" and r["objective"] == "static-cost:density"
    assert r["value"] == r["predicted_ms"] > 0 and r["device"] == "h100"


def test_micro_sweep_writes_events_and_a_table(tmp_path, capsys):
    out, table = str(tmp_path / "tune"), str(tmp_path / "table.json")
    rc = tcli.main(["--device", "cpu", "--case", "sedov", "--side", "8", "--knobs",
                    "cell_target", "--budget", "3", "--commit", "best", "--out", out,
                    "--write-table", table, "--steps", "2"])
    assert rc == 0
    with open(os.path.join(out, "events.jsonl")) as f:
        events = [json.loads(line) for line in f if line.strip()]
    sweeps = [e for e in events if e["kind"] == "sweep"]
    assert [e["candidate"] for e in sweeps] == [0, 1, 2]
    assert [e["knobs"] for e in sweeps] == [{}, {"cell_target": 64}, {"cell_target": 256}]
    assert all(not validate_event(e) for e in events)
    assert any(e["kind"] == "tuning" and e["source"] == "sweep" for e in events)
    t = ttable.load_table(table)
    assert ttable.validate_table(t) == [] and len(t["entries"]) == 1
    e = t["entries"][0]
    assert (e["workload"], e["n_bucket"], e["p"], e["backend"]) == ("sedov", "1e2", 1,
                                                                   "pallas")
    assert e["provenance"]["device"] == "cpu"
    assert not os.path.exists(os.path.join(out, "blackbox.json"))
    # a phase objective: one phase of the torch.profiler capture per step
    r = tt.measure_candidate(tt.ReplaySpec(case="sedov", side=8, device="cpu"),
                             {"gap": 128}, steps=2, objective="phase:density",
                             trace_dir=str(tmp_path / "trace"))
    assert r["status"] == "ok" and 0 < r["value"] == r["phase_us"] / r["steps"]
    assert r["config"]["gap"] == 128
    # the static roofline objective sweeps on the CPU; a sweep over two
    # gloo ranks runs (rank 0 writes the p = 2 entry); the refusals: an
    # unknown cost device, no card
    assert tcli.main(["--device", "cpu", "--case", "sedov", "--side", "8", "--out", out,
                      "--objective", "static-cost:density", "--budget", "2",
                      "--quiet"]) == 0
    ranked = str(tmp_path / "ranked.json")
    assert tcli.main(["--device", "cpu", "--case", "sedov", "--side", "8", "--out", out,
                      "--devices", "2", "--knobs", "cell_target", "--budget", "2",
                      "--steps", "2", "--commit", "best", "--write-table", ranked,
                      "--quiet"]) == 0
    assert [e["p"] for e in ttable.load_table(ranked)["entries"]] == [2]
    for extra in (["--objective", "static-cost:density", "--cost-device", "v5e"],):
        assert tcli.main(["--device", "cpu", "--case", "sedov", "--side", "8",
                          "--out", out] + extra) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["--case", "sedov", "--side", "8", "--out", out])


def test_sweep_over_two_gloo_ranks_agrees(tmp_path):
    """One spawn of two gloo ranks, each running its sweep as
    ``sweep_on_ranks`` runs it: every rank takes the same candidates and
    ends with the same history; each agreed value is the maximum of the
    ranks' own; the entry of the result keys as the JAX package's entry of
    the same spec at p = 2. Then a candidate that raises on rank 1 alone:
    both ranks record it ``failed`` with rank 0's value beside None, and
    both go on to the same next candidate."""
    from sphexa_torch.parallel.mesh import spawn

    from torch_rank_sweeps import sweep_and_fault

    spec = tt.ReplaySpec(case="sedov", side=8, devices=2, device="cpu")
    fault = {"cell_target": 64}
    ranks = spawn(sweep_and_fault, 2, args=(spec, tt.domains_for(["cell_target"]), 3, 2, fault),
                  workdir=str(tmp_path), device="cpu", backend="gloo", threads=1, timeout=600)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["candidates"] == 3 for r in ranks)

    def agreed(r):
        return [(h["candidate"], h["knobs"], h["status"], h["value"], h["rank_values"])
                for h in r["history"]]

    assert agreed(ranks[0]) == agreed(ranks[1])
    assert [h["knobs"] for h in ranks[0]["history"]] == [{}, {"cell_target": 64},
                                                        {"cell_target": 256}]
    for i, h in enumerate(ranks[0]["history"]):
        own = [r["history"][i]["own"]["value"] for r in ranks]
        assert h["status"] == "ok" and h["rank_values"] == own
        assert h["value"] == max(own) and h["per_step_s"] == h["value"]
    assert ranks[0]["best"] == ranks[1]["best"]
    backend = tsim.resolve_backend(spec.backend)
    entry = ttable.make_entry(spec.case, spec.n, spec.devices, backend,
                              ranks[0]["best"]["knobs"] or {"cell_target": 64}, {})
    jentry = jtable.make_entry(spec.case, spec.n, 2, backend, dict(entry["knobs"]), {})
    assert jtable.entry_key(entry) == jtable.entry_key(jentry)
    assert entry["p"] == 2

    # trouble 3: the candidate raised on rank 1 only; no rank waited alone
    faulted = [r["faulted"] for r in ranks]
    assert agreed(faulted[0]) == agreed(faulted[1])
    assert [h["knobs"] for h in faulted[0]["history"]] == [{}, fault, {"cell_target": 256}]
    for r, f in enumerate(faulted):
        bad = f["history"][1]
        assert (bad["status"], bad["value"]) == ("failed", None)
        assert bad["rank_values"][1] is None and bad["rank_values"][0] > 0
        assert "rank(s) [1]" in bad["error"]
        assert bad["own"]["status"] == ("ok" if r == 0 else "failed")
        assert [h["status"] for h in f["history"]] == ["ok", "failed", "ok"]


def test_agree_takes_the_worst_status_and_the_slowest_rank(tmp_path):
    """``agree`` on one rank (the all_gather of a one-rank mesh): a failed
    result is failed with no value; on two ranks the tests above hold the
    maximum."""
    import torch.distributed as dist

    from sphexa_torch.parallel.mesh import Mesh
    from sphexa_torch.tuning.replay import agree

    if dist.is_initialized():
        pytest.skip("a process group is already running")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", rank=0,
                            world_size=1)
    try:
        mesh = Mesh(group=dist.group.WORLD, rank=0, size=1, device=torch.device("cpu"),
                    backend="gloo")
        ok = agree(mesh, {"status": "overflow", "value": 2.0, "per_step_s": 2.0, "steps": 4})
        assert (ok["status"], ok["value"], ok["rank_values"], ok["steps"]) == \
            ("overflow", 2.0, [2.0], 4)
        bad = agree(mesh, {"status": "failed", "value": None, "error": "RuntimeError: x"})
        assert (bad["status"], bad["value"], bad["rank_values"]) == ("failed", None, [None])
        assert bad["own"]["error"] == "RuntimeError: x" and "rank(s) [0]" in bad["error"]
    finally:
        dist.destroy_process_group()
