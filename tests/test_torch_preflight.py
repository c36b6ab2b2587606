"""The port's SPMD audit (sphexa_torch/devtools/audit: the sharded registry
entries on ranks, spmd.py, JXA106 and JXA201-JXA204, ``preflight``) on the
CPU, against the JAX package's (sphexa_tpu/devtools/audit) where they meet.

One spawn of two gloo ranks (one torch thread each) records every sharded
entry of the registry and of the fixtures (``core.run_sharded``), and one
of four the registry's for ``preflight --mesh 4``, the two at once and the
JAX references computed meanwhile.

- The outputs of ``halo_exchange_sparse``, ``halo_exchange_windowed``,
  ``observable_ledger_sharded``, ``observable_snapshot_sharded`` and
  ``tree_build_sizing``, gathered over the ranks, against the JAX entries'
  ``fn(*args)`` on the conftest's CPU mesh: the j-buffers, the exchange
  metrics and the sizing bit for bit, the ledger within
  tests/test_torch_ledger.py's tolerances (etot and eint rel 1e-6, ecin
  rel 1e-4, the counts and extrema exactly), the snapshot within
  ``app_checks.DEPOSIT_RTOL`` of the grid's max.
- The step and gravity entries' ``exchange_budget_bytes`` equal to the JAX
  builders' (the halo sizing's caps and the MAC-sized gravity caps).
- ``preflight --cpu`` at ``--mesh 2`` and ``--mesh 4`` exits 0 over the
  registry with a row an entry; ``--hbm-budget 1`` fails
  ``step_std_sharded`` with JXA202; the usage errors exit 2; the
  ``--json`` payload carries the JAX payload's keys.
- Each SPMD fixture (tests/torch_audit_fixtures: jxa106, jxa201, jxa202,
  jxa203, jxa204, jxa401_collective) fires exactly its rule at its
  ``# expect:`` lines, and its clean twins give no finding.
"""

import dataclasses
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from sphexa_torch.devtools.audit import cli as tcli
from sphexa_torch.devtools.audit import registry as treg
from sphexa_torch.devtools.audit.core import (
    audit_context,
    entries_from_namespace,
    entry_trace,
    run_sharded,
    set_audit_context,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join("tests", "torch_audit_fixtures")
SPMD_FIXTURES = ("jxa106.py", "jxa201.py", "jxa202.py", "jxa203.py", "jxa204.py",
                 "jxa401_collective.py")
OUTPUT_ENTRIES = ("halo_exchange_sparse", "halo_exchange_windowed",
                  "observable_ledger_sharded", "observable_snapshot_sharded",
                  "tree_build_sizing")
BUDGET_ENTRIES = ("step_std_sharded", "step_std_blockdt_sharded", "gravity_sharded",
                  "gravity_sharded_windowed")
_EXPECT = re.compile(r"#\s*expect:\s*([A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)")


@pytest.fixture(scope="module", autouse=True)
def cpu_module():
    """The module on the CPU from the repository's root (the fixtures' and
    the committed files' paths), one torch thread."""
    threads, cwd = torch.get_num_threads(), os.getcwd()
    torch.set_num_threads(1)
    os.chdir(ROOT)
    prev = set_audit_context(dataclasses.replace(audit_context(), device="cpu", mesh_size=2))
    yield
    set_audit_context(prev)
    os.chdir(cwd)
    torch.set_num_threads(threads)


def _fixture_entries(name):
    return entries_from_namespace(vars(tcli._load_target(os.path.join(FIXTURES, name))))


def _registry():
    return {e.name: e for e in entries_from_namespace(vars(treg))}


def _jax_refs():
    """The JAX entries' outputs and budgets (the conftest's CPU mesh)."""
    from sphexa_tpu.devtools.audit import registry as jreg

    outs, budgets = {}, {}
    for name in OUTPUT_ENTRIES:
        case = getattr(jreg, name).build()
        out = case.fn(*case.args)
        outs[name] = _np(out)
    for name in BUDGET_ENTRIES:
        budgets[name] = getattr(jreg, name).build().exchange_budget_bytes
    return outs, budgets


def _np(obj):
    if isinstance(obj, dict):
        return {k: _np(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_np(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    return np.asarray(obj)


@pytest.fixture(scope="module")
def records():
    """Every sharded entry of the registry and the fixtures on two ranks,
    one spawn, and the registry's on four (``preflight --mesh 4``'s); the
    JAX references while they run."""
    registry = [e for e in _registry().values() if e.mesh_axes]
    entries = list(registry)
    for name in SPMD_FIXTURES:
        entries += [e for e in _fixture_entries(name) if e.mesh_axes]
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(run_sharded, entries, "cpu", 2),
                   pool.submit(run_sharded, registry, "cpu", 4)]
        refs = _jax_refs()
        for f in futures:
            f.result()
    return refs


def _ranks(name):
    return [v.out for v in entry_trace(_registry()[name]).ranks]


# -- the entries against the JAX package's ---------------------------------------


def _check_exchange(port, jax_out):
    for i in range(4):  # the j-buffers [own | halo] of x, y, z, m
        np.testing.assert_array_equal(np.concatenate([r[i].numpy() for r in port]), jax_out[i])
    for r in port:
        sdiag = r[5]
        assert set(sdiag) == set(jax_out[5])
        for k, v in jax_out[5].items():
            np.testing.assert_array_equal(sdiag[k].numpy(), v, err_msg=k)
        assert int(sdiag["shard_trips"].max()) == int(jax_out[4])


def _check_ledger(port, jd):
    for r in port:
        assert set(r) == set(jd)
        td = {k: float(v) for k, v in r.items()}
        for k in ("obs_etot", "obs_eint"):
            assert td[k] == pytest.approx(float(jd[k]), rel=1e-6), k
        assert td["obs_ecin"] == pytest.approx(float(jd["obs_ecin"]), rel=1e-4)
        for k in set(jd) - {"obs_etot", "obs_eint", "obs_ecin"}:
            np.testing.assert_equal(td[k], float(jd[k]), err_msg=k)


def _check_snapshot(port, jd):
    from sphexa_torch.kernels.app_checks import DEPOSIT_RTOL

    for r in port:
        assert set(r) == set(jd)
        scale = float(np.abs(jd["snap_grid"]).max())
        for k, v in jd.items():
            np.testing.assert_allclose(r[k].numpy(), v, rtol=0, atol=DEPOSIT_RTOL * scale,
                                       err_msg=k)


def _check_sizing(port, jout):
    jocc, jext, jhist = jout
    for occ, ext, hist in port:
        assert occ == int(jocc)
        np.testing.assert_array_equal(np.asarray(ext, dtype=np.float32), jext)
        np.testing.assert_array_equal(hist.numpy(), jhist)
        assert hist.dtype == torch.int32


@pytest.mark.parametrize("name,check", [
    ("halo_exchange_sparse", _check_exchange),
    ("halo_exchange_windowed", _check_exchange),
    ("observable_ledger_sharded", _check_ledger),
    ("observable_snapshot_sharded", _check_snapshot),
    ("tree_build_sizing", _check_sizing),
], ids=lambda v: v if isinstance(v, str) else None)
def test_outputs_match_jax(name, check, records):
    outs, _ = records
    check(_ranks(name), outs[name])


@pytest.mark.parametrize("name", BUDGET_ENTRIES)
def test_exchange_budget_matches_jax(name, records):
    _, budgets = records
    views = entry_trace(_registry()[name]).ranks
    assert {v.case.exchange_budget_bytes for v in views} == {budgets[name]}
    # the port's step runs its distributed sort, which the JAX entry leaves out
    assert all(v.case.sort_bytes > 0 for v in views) == name.startswith("step_")


# -- preflight ------------------------------------------------------------------------


def _run(argv, capsys):
    rc = tcli.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("P", [2, 4])
def test_preflight_clean(P, records, capsys):
    """The package registry preflights clean on P gloo ranks, a table row an
    entry, the campaign peak a rank on the sharded ones."""
    rc, out = _run(["preflight", "--cpu", "--mesh", str(P)], capsys)
    assert rc == 0, out
    rows = {ln.split()[0]: ln.split() for ln in out.splitlines() if ln and ln.split()[0]
            in _registry()}
    assert set(rows) == set(_registry())
    for name, e in _registry().items():
        assert rows[name][2] == "ok", rows[name]
        assert (rows[name][4] != "-") == bool(e.mesh_axes), rows[name]
    assert f"ranks P={P} on cpu" in out and "torchaudit preflight: 0 finding(s)" in out


def test_preflight_hbm_budget_flags_jxa202(records, capsys):
    rc, out = _run(["preflight", "--cpu", "--mesh", "2", "--entries", "step_std_sharded",
                    "--hbm-budget", "1"], capsys)
    assert rc == 1
    assert re.findall(r": (JXA\d{3}) \[", out) == ["JXA202"], out


def test_preflight_usage_errors(capsys):
    for argv in (["preflight", "--mesh", "1"], ["preflight", "--mesh", "0"],
                 ["preflight", "--cpu", "--entries", "nope"],
                 ["preflight", "no_such_module_xyz", "--cpu"]):
        assert tcli.main(argv) == 2, argv


def test_preflight_json_keys_match_jax(records, capsys):
    """The payload's keys, and an entry's, include the JAX preflight's (its
    ``knob_inertness`` row, a stub, traced on the conftest's mesh)."""
    from sphexa_tpu.devtools.audit.preflight import main as jax_preflight

    assert jax_preflight(["--mesh", "2", "--entries", "knob_inertness", "--json"]) == 0
    jax = json.loads(capsys.readouterr().out)
    rc, out = _run(["preflight", "--cpu", "--mesh", "2", "--json", "--entries",
                    "knob_inertness,step_std_sharded"], capsys)
    assert rc == 0, out
    port = json.loads(out)
    assert set(jax) <= set(port) and set(jax["campaign"]) <= set(port["campaign"])
    assert all(set(jax["entries"][0]) <= set(e) for e in port["entries"])
    row = {e["entry"]: e for e in port["entries"]}["step_std_sharded"]
    assert row["mesh_size"] == 2 and row["chain"] == "ok" and len(row["ranks"]) == 2
    assert row["exchange_bytes"] <= 2 * (row["exchange_budget_bytes"] + row["sort_bytes"])
    assert port["campaign"] == {"n": 64_000_000, "devices": 8, "hbm_budget_bytes": 80 * 10**9,
                                "traced_mesh": 2, "device": "cpu"}


def test_list_rules_has_spmd_rules(capsys):
    rc, out = _run(["--list-rules"], capsys)
    assert rc == 0
    assert {"JXA106", "JXA201", "JXA202", "JXA203", "JXA204"} <= {
        ln.split()[0] for ln in out.splitlines()}


# -- the rules on their fixtures ---------------------------------------------------------


def _expected(path):
    out = set()
    for i, line in enumerate(open(path).read().splitlines(), start=1):
        m = _EXPECT.search(line)
        if m:
            out |= {(i, r.strip()) for r in m.group(1).split(",")}
    return out


@pytest.mark.parametrize("name", SPMD_FIXTURES)
def test_spmd_fixture_findings_exact(name, records, capsys):
    """The fixture's findings (every rule of the default gate) are its
    ``# expect:`` markers, exactly: each at its entry's line."""
    path = os.path.join(FIXTURES, name)
    rc, out = _run([path, "--cpu", "--format", "json"], capsys)
    got = json.loads(out)
    assert not got["errors"], got["errors"]
    found = {(f["line"], f["rule"]) for f in got["findings"]}
    assert found == _expected(path), out
    assert rc == 1
