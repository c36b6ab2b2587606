"""The port's trace rules, lowering lock and statecheck
(sphexa_torch/devtools/audit) on the CPU, against the JAX package's
(sphexa_tpu/devtools/audit) where they meet.

- The rule catalog: the port's ids and names equal the JAX registry's.
- The registry at zero findings, and the committed LOWERING_LOCK_TORCH.json
  and STATE_SCHEMA_TORCH.json hold; every entry recorded once in this
  module (``core.entry_trace``), the grow probes the only second builds
  (two records of an entry agree: tests/test_torch_costmodel.py's
  determinism test, on the cost layer's two tallies).
- Phase order and schema rows of the nine shared entries against the JAX
  package's committed LOWERING_LOCK.json and STATE_SCHEMA.json, the
  differences named (``PHASE_ORDER_DIFFS``, ``SCHEMA_DIFFS``).
- The lock's diff on a seeded change, ``--write`` round trips, and the
  ``--format json`` keys of the JAX CLI.
- Each rule's fixtures (tests/torch_audit_fixtures): the firing one exits
  1 with the rule's id, the clean one 0; JXA104's sites at their lines,
  JXA401 on the snapshot deposit's old form and silent on its new one,
  JXA402 on a perturbing knob spec.
"""

import json
import os
import re

import pytest
import torch

from sphexa_torch.devtools.audit import cli as tcli
from sphexa_torch.devtools.audit import lowerdiff, registry, statecheck
from sphexa_torch.devtools.audit.core import (
    Auditor,
    all_rules,
    audit_context,
    entries_from_namespace,
    entry_trace,
    set_audit_context,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_audit_fixtures")
#: the entries the port's registry shares with the JAX package's
SHARED = ("step_std", "step_ve", "step_nbody", "step_turb_ve", "step_std_cooling",
          "gravity_solve", "step_std_blockdt", "observable_ledger", "observable_snapshot")
#: the port's phase order where it differs from the JAX lock's, and why:
#: the VE steps form their density time step (``rho_timestep`` of divv,
#: before the AV switches) inside a ``timestep`` scope in the port, where
#: the JAX step computes it outside every scope (unattributed there)
PHASE_ORDER_DIFFS = {
    "step_ve": ["sort", "neighbors", "xmass", "gradh", "eos", "iad", "divv-curlv",
                "timestep", "av-switches", "momentum-energy", "timestep", "integrate"],
    "step_turb_ve": ["sort", "neighbors", "xmass", "gradh", "eos", "iad", "divv-curlv",
                     "timestep", "av-switches", "momentum-energy", "timestep", "turbulence",
                     "integrate"],
}
#: (entry, JAX path) -> the port's (dtype, axis kinds) where they differ, and
#: why: the port's step diagnostics add ``nc_sum`` (the exact int64
#: neighbour total, dtypes.INT64_OUTPUTS: the float32 mean may round apart
#: on two devices) and keep the SPH search's ``occupancy`` in its int64 (a
#: cast would add a kernel to every step; the N-body step's is int32); the
#: ledger's sums are float64 on the device in both
#: packages, which the JAX lock, traced without x64, records as float32;
#: the turbulence's random key lives on the host in the port (state.py),
#: a numpy uint32 pair
SCHEMA_DIFFS = {
    **{(e, "[2]['nc_sum']"): ("int64", []) for e in SHARED if e.startswith("step_")},
    **{(e, "[2]['occupancy']"): ("int64", []) for e in SHARED
       if e.startswith("step_") and e != "step_nbody"},
    **{("observable_ledger", f"['obs_{k}']"): ("float64", [])
       for k in ("angmom", "ecin", "egrav", "eint", "etot", "linmom")},
    ("step_turb_ve", "[3].key"): ("numpy.uint32", ["const"]),
}
#: the port's step output (SimState, diagnostics) under the JAX step's
#: (state, box, diagnostics, aux) paths
_PATH_MAP = ((r"^\[0\]\.particles\.", "[0]."), (r"^\[0\]\.box\.", "[1]."),
             (r"^\[1\]\[", "[2]["), (r"^\[0\]\.(bdt|turb|chem)\.", "[3]."))


@pytest.fixture(scope="module", autouse=True)
def cpu_module():
    """The whole module on the CPU, one torch thread (the entries' tensors
    are a few hundred rows: threads only contend with the other workers)."""
    import dataclasses

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = set_audit_context(dataclasses.replace(audit_context(), device="cpu"))
    yield
    set_audit_context(prev)
    torch.set_num_threads(threads)


@pytest.fixture
def in_root(monkeypatch):
    monkeypatch.chdir(ROOT)


def _run(argv, capsys):
    rc = tcli.main(argv)
    return rc, capsys.readouterr().out


def _entries():
    return {e.name: e for e in entries_from_namespace(vars(registry))}


def _merged_phases(runs):
    """The phase sequence of ``phase_runs``, unattributed runs dropped and
    neighbours merged."""
    out = []
    for phase, _n in runs:
        if phase != "(unattributed)" and (not out or out[-1] != phase):
            out.append(phase)
    return out


# -- the catalog and the committed locks ---------------------------------------


def test_rule_catalog_matches_jax():
    from sphexa_tpu.devtools.audit.core import all_rules as jax_rules

    port, jax = all_rules(), jax_rules()
    assert {"JXA101", "JXA104", "JXA105", "JXA106", "JXA201", "JXA202", "JXA203", "JXA204",
            "JXA301", "JXA302", "JXA303", "JXA401", "JXA402", "JXA501", "JXA502",
            "JXA503"} == set(port)
    for rid, rule in port.items():
        assert rule.name == jax[rid].name, rid


def test_registry_clean_and_locks_hold(in_root, capsys):
    """The default mode, ``lowering`` and ``schema`` over the registry on the
    CPU: zero findings, the committed files hold (one recorded run of each
    entry, shared by the three modes)."""
    rc, out = _run(["--cpu"], capsys)
    assert rc == 0, out
    assert "torchaudit: 0 finding(s)" in out
    rc, out = _run(["lowering", "--cpu"], capsys)
    assert rc == 0, out
    assert f"{len(_entries())}/{len(_entries())} entries match" in out
    rc, out = _run(["schema", "--cpu"], capsys)
    assert rc == 0, out
    assert f"{len(_entries())}/{len(_entries())} entries match" in out


def test_launch_contract_in_lock():
    """The lock's launch map: K12 and K13 once a gravity solve, K1's ops once
    a streaming step and K12 once where it has self-gravity, K13's one-row
    form once a block-dt step, K5 and each walk once in list mode, K1 never
    there; on each of the two ranks of a sharded entry, K1's jdata ops once
    a step, K12's jdata form and K13 once a sharded gravity stage, none in
    an exchange, the ledger, the snapshot or the sizing."""
    lock = lowerdiff.load_lock(os.path.join(ROOT, lowerdiff.DEFAULT_LOCK_PATH))
    std = {"density": 1, "iad": 1, "momentum_energy_std": 1}
    ve = {"density": 1, "ve_def_gradh": 1, "iad": 1, "iad_divv_curlv": 1, "av_switches": 1,
          "momentum_energy_ve": 1}
    want = {
        "gravity_solve": {"gravity_p2p": 1, "compact_class_lists": 1},
        "step_std": std, "step_ve": ve, "step_turb_ve": ve,
        "step_nbody": {"gravity_p2p": 1},
        "step_std_cooling": {**std, "gravity_p2p": 1},
        "step_std_blockdt": {**std, "compact_row": 1},
        "step_std_lists": {"mark": 1, "density_lists": 1, "iad_lists": 1,
                           "momentum_energy_std_lists": 1},
        "step_ve_lists": {"mark": 1, **{f"{k}_lists": 1 for k in ve}},
        "observable_ledger": {}, "observable_snapshot": {}, "knob_inertness": {},
    }
    grav = {"gravity_p2p": 1, "compact_class_lists": 1}
    sharded = {"gravity_sharded": grav, "gravity_sharded_windowed": grav,
               "step_std_sharded": std, "step_std_blockdt_sharded": {**std, "compact_row": 1},
               **{k: {} for k in ("halo_exchange_sparse", "halo_exchange_windowed",
                                  "observable_ledger_sharded", "observable_snapshot_sharded",
                                  "tree_build_sizing")}}
    want.update({k: [v, v] for k, v in sharded.items()})
    assert {k: [r["launches"] for r in v["ranks"]] if "ranks" in v else v["launches"]
            for k, v in lock.items()} == want
    assert all(v["mesh"] == 2 for v in lock.values() if "ranks" in v)
    for name in ("step_std_lists", "step_ve_lists"):
        fp = lowerdiff.lowering_fingerprint(entry_trace(_entries()[name]))
        assert fp.launches == want[name]
    trace = entry_trace(_entries()["step_std_sharded"])
    assert [fp.launches for fp in lowerdiff.rank_fingerprints(trace)] == want["step_std_sharded"]


def test_phase_order_matches_jax_lock():
    with open(os.path.join(ROOT, "LOWERING_LOCK.json")) as f:
        jax_lock = json.load(f)["entries"]
    port_lock = lowerdiff.load_lock(os.path.join(ROOT, lowerdiff.DEFAULT_LOCK_PATH))
    for name in SHARED:
        got = _merged_phases(port_lock[name]["phase_runs"])
        want = PHASE_ORDER_DIFFS.get(name, _merged_phases(jax_lock[name]["phase_runs"]))
        assert got == want, name
        fp = lowerdiff.lowering_fingerprint(entry_trace(_entries()[name]))
        assert fp.lock_payload() == port_lock[name], name
    for name, order in PHASE_ORDER_DIFFS.items():
        assert _merged_phases(jax_lock[name]["phase_runs"]) != order


def _jax_path(entry, path):
    if not entry.startswith("step_"):
        return path
    for a, b in _PATH_MAP:
        if re.match(a, path):
            return re.sub(a, b, path)
    return path


def test_schema_rows_match_jax():
    """Leaf by leaf, the JAX STATE_SCHEMA.json's dtypes and axis kinds (and
    its grow ratios: 64/27 for the cube, 275/117 for the Evrard sphere),
    under the path map, but for ``SCHEMA_DIFFS``."""
    with open(os.path.join(ROOT, "STATE_SCHEMA.json")) as f:
        jax_schema = json.load(f)["entries"]
    port_schema = statecheck.load_lock(os.path.join(ROOT, statecheck.DEFAULT_SCHEMA_PATH))
    seen = set()
    for name in SHARED:
        row = statecheck.entry_schema(entry_trace(_entries()[name]))
        assert row == port_schema[name], name
        want = jax_schema[name]
        assert (row["grow"], row["n_base"]) == (want["grow"], want["n_base"]), name
        got = {_jax_path(name, p): (leaf["dtype"], [a["kind"] for a in leaf["shape"]])
               for p, leaf in row["leaves"].items()}
        for path, kinds in got.items():
            if (name, path) in SCHEMA_DIFFS:
                seen.add((name, path))
                assert kinds == SCHEMA_DIFFS[(name, path)], (name, path)
                continue
            jl = want["leaves"][path]
            assert kinds == (jl["dtype"], [a["kind"] for a in jl["shape"]]), (name, path)
        assert set(want["leaves"]) <= set(got), (name, set(want["leaves"]) - set(got))
    assert seen == set(SCHEMA_DIFFS)


def test_json_keys_match_jax(in_root, capsys):
    from sphexa_tpu.devtools.common import render_json

    want = set(json.loads(render_json([], [], [], [])))
    rc, out = _run(["--cpu", "--format", "json", "--entries", "observable_snapshot"], capsys)
    assert rc == 0
    assert set(json.loads(out)) == want


# -- the lock's diff --------------------------------------------------------------


def test_lock_diff_and_write(tmp_path, in_root, capsys):
    """A lock with one row of ``step_std``'s integrate phase fewer (the run
    has one op more) and one density launch fewer: exit 1 naming the row,
    the phase and the launch; ``--write`` re-locks and round-trips."""
    lock = json.loads(open(os.path.join(ROOT, lowerdiff.DEFAULT_LOCK_PATH)).read())
    row = lock["entries"]["step_std"]
    fp = lowerdiff.lowering_fingerprint(entry_trace(_entries()["step_std"]))
    first = fp.line_phases.index("integrate")
    w = 8
    row["eqn_hashes"] = row["eqn_hashes"][:w * first] + row["eqn_hashes"][w * (first + 1):]
    row["phase_runs"] = [[p, n - 1 if p == "integrate" else n] for p, n in row["phase_runs"]]
    row["phases"]["integrate"] = {"digest": "0" * 32,
                                  "eqns": row["phases"]["integrate"]["eqns"] - 1}
    row["launches"]["density"] = 0
    doctored = tmp_path / "lock.json"
    doctored.write_text(json.dumps(lock))
    rc, out = _run(["lowering", "--cpu", "--lock", str(doctored), "--entries", "step_std"],
                   capsys)
    assert rc == 1
    assert f"first divergence: row #{first} (phase integrate)" in out
    assert "~ integrate: +1/-0 rows" in out
    assert "launches: density 0 -> 1" in out
    assert "0/1 entries match" in out
    rc, out = _run(["lowering", "--cpu", "--lock", str(doctored), "--entries", "step_std",
                    "--write"], capsys)
    assert rc == 0
    assert lowerdiff.load_lock(doctored)["step_std"] == fp.lock_payload()
    rc, out = _run(["lowering", "--cpu", "--lock", str(doctored), "--entries", "step_std"],
                   capsys)
    assert rc == 0, out
    assert _run(["lowering", "--cpu", "--lock", str(tmp_path / "none.json")], capsys)[0] == 2


# -- the rules on their fixtures ---------------------------------------------------


def _fixture(name):
    return os.path.join("tests", "torch_audit_fixtures", name)


@pytest.mark.parametrize("path,rule,fires,clean", [
    ("jxa101.py", "JXA101", "jxa101_fires,jxa101_x64", "jxa101_clean"),
    ("jxa104.py", "JXA104", "jxa104_fires", "jxa104_clean,jxa104_declared"),
    ("jxa105.py", "JXA105", "jxa105_fires", "jxa105_clean"),
    ("jxa401.py", "JXA401", "jxa401_fires", "jxa401_clean,jxa401_snapshot"),
    ("jxa402.py", "JXA402", "jxa402_fires", "jxa402_clean"),
    ("jxa50x.py", "JXA503", "jxa503_fires", "jxa503_clean"),
], ids=lambda v: v if isinstance(v, str) and v.startswith("JXA") else None)
def test_rule_fixture(path, rule, fires, clean, in_root, capsys):
    rc, out = _run([_fixture(path), "--cpu", "--entries", fires], capsys)
    assert rc == 1, out
    hits = [ln for ln in out.splitlines() if f": {rule} [" in ln]
    assert len({h.split("[", 1)[1].split("]")[0] for h in hits}) == len(fires.split(",")), out
    assert not [ln for ln in out.splitlines() if re.search(r": JXA\d{3} \[", ln)
                and f": {rule} [" not in ln], out
    rc, out = _run([_fixture(path), "--cpu", "--entries", clean], capsys)
    assert rc == 0, out


def test_jxa104_sites_at_their_lines(in_root):
    """The fixture's ``.item()``, ``.tolist()``, ``nonzero`` and boolean-mask
    lines (each ends in ``# sync``), each once, with its reason."""
    from sphexa_torch.devtools.audit.rules.jxa104_host_boundary import sync_sites

    src = open(os.path.join(FIXTURES, "jxa104.py")).read().splitlines()
    lines = [i + 1 for i, ln in enumerate(src) if ln.endswith("# sync")]
    trace = entry_trace(_load(_fixture("jxa104.py"))["jxa104_fires"])
    site = _fixture("jxa104.py").replace(os.sep, "/")
    assert dict(sync_sites(trace)) == {
        f"{site}:{lines[0]} (item)": 1, f"{site}:{lines[1]} (tolist)": 1,
        f"{site}:{lines[2]} (data-dependent size)": 1,
        f"{site}:{lines[3]} (boolean-mask index)": 1}


def _load(path):
    return {e.name: e for e in entries_from_namespace(vars(tcli._load_target(path)))}


def test_jxa401_snapshot_deposit(in_root):
    """The old deposit (a float ``index_add_`` onto repeated cells) fires,
    the deposit as it is does not, and the two agree to float32 rounding."""
    entries = _load(_fixture("jxa401.py"))
    rule = all_rules()["JXA401"]
    old = entry_trace(entries["jxa401_fires"])
    assert [f.rule for f in rule.check(old)] == ["JXA401"]
    new = entry_trace(entries["jxa401_snapshot"])
    assert rule.check(new) == []
    from sphexa_torch.init import init_sedov
    from sphexa_torch.observables import snapshot

    state, box, _ = init_sedov(6, device="cpu")
    spec = snapshot.SnapshotSpec(fields=("rho", "temp"), grid=8)
    rho = torch.ones_like(state.m)
    got = snapshot.deposit(state, rho, box, spec)
    flat = torch.clamp(((state.x - box.lo[0]) / box.lengths[0] * 8).to(torch.int32), 0, 7)
    flat2 = torch.clamp(((state.y - box.lo[1]) / box.lengths[1] * 8).to(torch.int32), 0, 7)
    idx = flat2.to(torch.int64) * 8 + flat.to(torch.int64)
    w = torch.stack([rho, state.temp])
    want = torch.zeros((2, 64)).index_add_(1, idx, w)
    assert torch.allclose(got, want, rtol=1e-6, atol=0)


def test_statecheck_fixtures(in_root, capsys):
    """JXA501 through the schema mode's fixture lock, JXA502 under
    ``--vmap``: both exit 1 naming the rule."""
    lock = _fixture("jxa50x_lock.json")
    rc, out = _run(["schema", _fixture("jxa50x.py"), "--cpu", "--lock", lock, "--entries",
                    "jxa501_fires"], capsys)
    assert rc == 1 and "jxa501_fires: JXA501 state schema drifted" in out, out
    rc, out = _run(["schema", _fixture("jxa50x.py"), "--cpu", "--lock", lock, "--entries",
                    "jxa501_clean"], capsys)
    assert rc == 0, out
    import dataclasses

    ctx = dataclasses.replace(audit_context(), vmap_members=2, state_schema_path=lock)
    prev = set_audit_context(ctx)
    try:
        entries = _load(_fixture("jxa50x.py"))
        active, errors, _ = Auditor(select=["JXA501", "JXA502"]).run_entries(
            [entries[n] for n in ("jxa501_fires", "jxa501_clean", "jxa502_fires")])
    finally:
        set_audit_context(prev)
    assert not errors
    assert sorted((f.rule, f.message.split("]")[0][1:]) for f in active) == [
        ("JXA501", "jxa501_fires"), ("JXA502", "jxa502_fires")]


def test_cli_usage_errors(in_root, capsys):
    assert tcli.main(["preflight", "--mesh", "1"]) == 2
    assert tcli.main(["--cpu", "--select", "JXA999"]) == 2
    assert tcli.main(["--cpu", "--entries", "nope"]) == 2
    assert tcli.main(["schema", "--cpu", "--entries", "nope"]) == 2
    if not torch.cuda.is_available():
        for argv in ([], ["lowering"], ["schema"]):
            assert tcli.main(argv) == 2, argv  # the card unless --cpu
