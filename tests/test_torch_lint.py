"""torchlint (sphexa_torch/devtools/lint): the rule fixtures, the
suppression grammar against the JAX package's, the CLI, the package
lint-clean with a reason for every suppression, and JXL002 against the
audit's runtime record (JXA104): every explicit host read that the
registry's entries make on the CPU, on one device and on ranks, lies on a
line that JXL002 reports.

Fixture contract (tests/torch_lint_fixtures/, torch code): each file
carries ``# expect: JXLnnn`` markers on the lines that must give findings
(a code repeated for two findings on one line); a missed finding and an
unexpected one both fail.
"""

import ast
import dataclasses
import json
import os
import re
import sys
from pathlib import Path

import pytest
import torch

from sphexa_tpu.devtools.common import make_disable_re as jax_disable_re
from sphexa_tpu.devtools.common import parse_suppressions as jax_parse_suppressions
from sphexa_torch.devtools.common import make_disable_re, parse_suppressions
from sphexa_torch.devtools.lint import Analyzer, ModuleInfo, all_rules
from sphexa_torch.devtools.lint.cli import main as lint_main

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "torch_lint_fixtures"
JAX_FIXTURES = Path(__file__).resolve().parent / "lint_fixtures"
PACKAGE = ROOT / "sphexa_torch"

#: the package's inline suppressions, each with its reason (a new one is a
#: decision: add it here with the code's reason)
PACKAGE_SUPPRESSED = [
    ("sphexa_torch/parallel/sizing.py", "JXL002"),
    ("sphexa_torch/parallel/sizing.py", "JXL002"),
    ("sphexa_torch/parallel/sort.py", "JXL002"),
    ("sphexa_torch/simulation.py", "JXL002"),
    ("sphexa_torch/sph/pair_lists.py", "JXL002"),
]

_EXPECT_RE = re.compile(r"#\s*expect:\s*([A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)")

FIXTURE_FILES = sorted(p.relative_to(FIXTURES).as_posix() for p in FIXTURES.rglob("*.py"))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the audit's records are a few hundred rows."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def expected_findings(path: Path):
    out = []
    for i, line in enumerate(path.read_text().splitlines(), start=1):
        m = _EXPECT_RE.search(line)
        if m:
            out += [(i, code.strip()) for code in m.group(1).split(",")]
    return sorted(out)


def run_file(path: Path):
    return Analyzer().run_module(ModuleInfo.from_file(str(path)))


def _rel(path: str) -> str:
    return Path(path).resolve().relative_to(ROOT).as_posix()


def test_rule_registry_is_the_four_with_a_torch_meaning():
    rules = all_rules()
    assert sorted(rules) == ["JXL001", "JXL002", "JXL003", "JXL006"]
    assert all(r.description and r.name for r in rules.values())


def test_every_rule_has_a_fixture():
    names = {Path(f).name[:6].upper() for f in FIXTURE_FILES}
    assert names == set(all_rules())


@pytest.mark.parametrize("rel", FIXTURE_FILES)
def test_fixture_findings_exact(rel):
    path = FIXTURES / rel
    active, _ = run_file(path)
    actual = sorted((f.line, f.rule) for f in active)
    expected = expected_findings(path)
    assert expected, f"{rel} has no # expect: markers"
    assert actual == expected, (
        f"{rel}: unexpected {sorted(set(actual) - set(expected))}, "
        f"missed {sorted(set(expected) - set(actual))}\n"
        + "\n".join(f.format() for f in active))


def test_inline_suppression_needs_its_reason(tmp_path):
    active, suppressed = run_file(FIXTURES / "jxl002_host_sync.py")
    assert [f.snippet for f in suppressed] == ["kept = int(y.sum())"]
    assert all("kept" not in f.snippet for f in active)
    src = ("import torch\n"
           "A = torch.zeros(3)  # torchlint: disable=JXL001 -- a test constant\n"
           "B = torch.ones(3)  # torchlint: disable=JXL001\n"
           "C = torch.ones(3)  # jaxlint: disable=JXL001 -- the JAX tool's name\n")
    p = tmp_path / "m.py"
    p.write_text(src)
    active, suppressed, errors = Analyzer().run_paths([str(p)])
    assert [f.line for f in suppressed] == [2]
    assert [f.line for f in active] == [3, 4]
    assert [(f.rule, f.line) for f in errors] == [("JXL000", 3)]
    assert lint_main([str(p)]) == 1


def test_file_wide_and_comment_run_suppression(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("# torchlint: disable-file=JXL001 -- generated tables\n"
                 "import torch\nA = torch.zeros(3)\nB = torch.ones(3)\n")
    active, suppressed = run_file(p)
    assert active == [] and [f.line for f in suppressed] == [3, 4]
    p.write_text("import torch\n"
                 "# torchlint: disable=JXL001 -- a deliberate import-time table\n"
                 "# (made here on purpose)\n"
                 "TABLE = torch.zeros(3)\n"
                 "OTHER = torch.zeros(3)\n")
    active, suppressed = run_file(p)
    assert [f.line for f in active] == [5] and [f.line for f in suppressed] == [4]


def _suppression_sources():
    srcs = [p.read_text() for p in sorted(JAX_FIXTURES.rglob("*.py"))]
    srcs += [p.read_text() for p in sorted(PACKAGE.rglob("*.py"))]
    srcs += [p.read_text() for p in sorted(FIXTURES.rglob("*.py"))]
    srcs.append("x = 1  # jaxlint: disable=JXL002,JXL001 -- two\n"
                "# jaxlint: disable=JXL003\n\n"
                "s = '# jaxlint: disable=JXL006 -- in a string'\n"
                "# jaxlint: disable-file=JXL007 -- file wide\n")
    return srcs


def test_parse_suppressions_matches_jax_with_the_tool_swapped():
    """The same line -> rules tables as the JAX parser on the same sources,
    the directive's tool name swapped (jaxlint <-> torchlint)."""
    jre, tre = jax_disable_re("jaxlint"), make_disable_re("torchlint")
    n = 0
    for src in _suppression_sources():
        want = jax_parse_suppressions(src.replace("torchlint:", "jaxlint:"), jre)
        got = parse_suppressions(src.replace("jaxlint:", "torchlint:"), tre)
        assert (got.by_line, got.comment_only, got.comment_lines, got.file_wide) == \
            (want.by_line, want.comment_only, want.comment_lines, want.file_wide)
        n += len(got.by_line) + len(got.file_wide)
    assert n >= 8


def test_select_limits_rules():
    active, _, _ = Analyzer(select=["JXL001"]).run_paths(
        [str(FIXTURES / "jxl002_host_sync.py")])
    assert active == []
    with pytest.raises(ValueError):
        Analyzer(select=["JXL004"])


def test_cli_text_json_and_exit_codes(tmp_path, capsys):
    dirty = FIXTURES / "jxl001_import_tensors.py"
    clean = tmp_path / "clean.py"
    clean.write_text("import numpy as np\nA = np.zeros(3)\n")
    assert lint_main([str(clean)]) == 0
    assert "torchlint: 0 finding(s)" in capsys.readouterr().out
    assert lint_main([str(dirty)]) == 1
    out = capsys.readouterr().out
    assert "JXL001" in out and out.rstrip().endswith("torchlint: 8 finding(s)")
    assert lint_main([str(dirty), "--format", "json"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert set(payload) == {"findings", "errors", "baselined", "suppressed"}
    assert {f["rule"] for f in payload["findings"]} == {"JXL001"}
    assert payload["errors"] == [] and payload["baselined"] == []
    assert lint_main([str(dirty), "--select", "JXL006"]) == 0
    capsys.readouterr()
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(r in out for r in ("JXL001", "JXL002", "JXL003", "JXL006"))
    assert lint_main(["--select", "NOPE1", str(clean)]) == 2
    broken = tmp_path / "broken.py"
    broken.write_text("def f(:\n")
    assert lint_main([str(broken)]) == 1
    assert "JXL000" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        lint_main(["--format", "xml"])
    assert e.value.code == 2


def test_json_keys_match_jax(capsys):
    from sphexa_tpu.devtools.common import render_json

    assert lint_main([str(FIXTURES / "jxl006_collectives.py"), "--format", "json"]) == 1
    got = json.loads(capsys.readouterr().out)
    want = json.loads(render_json([], [], [], []))
    assert set(got) == set(want)


def test_package_lints_clean_with_reasons(capsys):
    """Zero active findings and errors over sphexa_torch; every suppression
    gives its reason and is one of the committed ones."""
    active, suppressed, errors = Analyzer().run_paths([str(PACKAGE)])
    assert active == [] and errors == [], "\n".join(f.format() for f in active + errors)
    assert sorted((_rel(f.path), f.rule) for f in suppressed) == sorted(PACKAGE_SUPPRESSED)
    for f in suppressed:
        table = ModuleInfo.from_file(f.path).suppressions
        assert len(table.reason(f.rule, f.line)) >= 6, f.format()
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        assert lint_main(["--format", "json", "--show-suppressed"]) == 0
    finally:
        os.chdir(cwd)
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == [] and len(payload["suppressed"]) == len(PACKAGE_SUPPRESSED)


def test_lint_modules_import_only_the_standard_library():
    """The lint never imports the code it scans: its modules import the
    standard library and the lint's own machinery only."""
    lint = PACKAGE / "devtools" / "lint"
    own = ("sphexa_torch.devtools.lint", "sphexa_torch.devtools.common")
    stdlib = set(sys.stdlib_module_names)
    files = sorted(lint.rglob("*.py")) + [PACKAGE / "devtools" / "common.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module] if isinstance(node, ast.ImportFrom) and node.module else []
            for name in names:
                assert name.split(".")[0] in stdlib or name.startswith(own), \
                    f"{path.name} imports {name}"


def test_jxl006_leaves_the_queries_alone():
    """The three modules that query the process group stay clean."""
    paths = [PACKAGE / "util" / "blocking.py", PACKAGE / "app" / "main.py",
             PACKAGE / "devtools" / "audit" / "tally.py"]
    active, suppressed, _ = Analyzer(select=["JXL006"]).run_paths([str(p) for p in paths])
    assert active == [] and suppressed == []


# -- JXL002 against JXA104's runtime record -----------------------------------

#: the host-boundary rows of an explicit read
_EXPLICIT = re.compile(r"^host:(item|tolist|cpu|numpy|to\(cpu\)|__bool__|__int__|__float__)\(")


@pytest.fixture(scope="module")
def sync_rows():
    """Every explicit-read sync row of the registry's CPU records (the
    one-device entries, the list cases, the sharded ones at P = 2: one
    spawn), as (entry, site)."""
    from sphexa_torch.devtools.audit import registry
    from sphexa_torch.devtools.audit.core import (
        audit_context,
        entries_from_namespace,
        entry_trace,
        run_sharded,
        set_audit_context,
    )
    from sphexa_torch.kernels import cost_checks

    prev = set_audit_context(dataclasses.replace(audit_context(), device="cpu", mesh_size=2))
    try:
        entries = entries_from_namespace(vars(registry))
        names = {e.name for e in entries}
        entries += [e for e in getattr(cost_checks, "LIST_ENTRIES", ()) if e.name not in names]
        run_sharded(entries, "cpu", 2)
        rows = []
        for entry in entries:
            for rank in entry_trace(entry, "cpu").ranks:
                rows += [(entry.name, r.site) for r in rank.tally.rows
                         if r.flag == "sync" and _EXPLICIT.match(r.line)]
    finally:
        set_audit_context(prev)
    return rows


def test_every_explicit_sync_of_the_records_is_a_jxl002_line(sync_rows):
    active, suppressed, _ = Analyzer(select=["JXL002"]).run_paths([str(PACKAGE)])
    lines = {f"{_rel(f.path)}:{f.line}" for f in active + suppressed}
    entries = {name for name, _ in sync_rows}
    # the list cases' two reads, the sharded sort's cut table, the sizing's
    assert {"step_std_lists", "step_ve_lists", "step_std_sharded",
            "tree_build_sizing"} <= entries
    missed = sorted({(name, site) for name, site in sync_rows if site not in lines})
    assert not missed, f"syncs of the records that JXL002 does not report: {missed}"
