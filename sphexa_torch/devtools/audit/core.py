"""The audit core of the port (the JAX package's devtools/audit/core.py):
the entry-point model, the rule registry and the runner.

Where the JAX audit traces each registered entry to a jaxpr, the port has
none to read: an ``EntryCase`` holds a callable and its example args, and
the audit RUNS it (``EntryTrace.tally``: once untallied, so that lazy
set-up stays out, then once under ``tally.tallying``, which charges every
aten op and every kernel launch to its phase and keeps the ordered record
of the run, ``Tally.rows``, that the trace rules, the lowering lock and
statecheck read, and the run's output).

- An ``EntryPoint`` is a declaration: a name, the audit metadata the rules
  read (coverage floor, budget file, declared compute-bound phases, the
  constant budget, float64 as the default dtype, the grow probe and the
  host syncs it declares) and a lazy ``build`` callable returning an
  ``EntryCase``. Building is lazy so that importing a registry module
  stays cheap and device-free.
- ``EntryTrace`` caches the expensive per-entry artifacts (the run, the
  tally, the cost report, the fingerprint, the schema) so that each rule
  pays only for what it reads and nothing runs twice; ``entry_trace``
  keeps one per (entry, device) for the whole process, so that the CLI's
  modes and a test module share one recorded run of each entry.
- Rules are ``check(trace) -> [Finding]`` callables registered under JXA
  ids. Findings anchor at the entry's registration site. (The JAX audit's
  inline ``disable=`` grammar and baseline are not ported: no finding of
  the port is grandfathered.)

``JXA000`` is reserved for entries whose build or run raises: a broken
registry entry can never silently shrink coverage.
"""

import dataclasses
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from sphexa_torch.devtools.common import Finding

__all__ = [
    "AuditContext",
    "audit_context",
    "set_audit_context",
    "EntryCase",
    "EntryPoint",
    "EntryTrace",
    "EntrySkip",
    "entrypoint",
    "entries_from_namespace",
    "entry_trace",
    "Rule",
    "register",
    "all_rules",
    "Auditor",
]

@dataclasses.dataclass(frozen=True)
class AuditContext:
    """Process-wide knobs the cost rules and the registry read."""

    #: where the registry's entries build their state and run: "cuda" (the
    #: card, the default of every entry point of the port) or "cpu"
    device: str = "cuda"
    #: device model the cost rules predict against (devices.py)
    cost_device: str = "h100"
    #: JXA301 default: minimum attributed-FLOP share per entry (per-entry
    #: phase_coverage_min overrides)
    phase_coverage_min: float = 0.7
    #: JXA302 default budget file (repo-root committed); an entry may pin
    #: its own via EntryPoint.cost_budget_file. A missing DEFAULT file
    #: skips the gate (out-of-repo use); a missing DECLARED file fails.
    cost_budget_path: str = "COST_BUDGET_TORCH.json"
    #: JXA501 default schema lock (repo-root committed); a missing DEFAULT
    #: file skips the gate (out-of-repo use)
    state_schema_path: str = "STATE_SCHEMA_TORCH.json"
    #: JXA502 member-axis width of the vmap probe; 0 disables it (the
    #: default gate: ``schema --vmap`` turns it on)
    vmap_members: int = 0


_CONTEXT = AuditContext()


def audit_context() -> AuditContext:
    return _CONTEXT


def set_audit_context(ctx: AuditContext) -> AuditContext:
    """Install a new context; returns the previous one (for restore)."""
    global _CONTEXT
    prev = _CONTEXT
    _CONTEXT = ctx
    return prev


class EntrySkip(Exception):
    """Raised by a builder when its prerequisites are absent. Skips are
    reported, not errors."""


@dataclasses.dataclass
class EntryCase:
    """The concrete case an entry's builder produces: ``fn(*args)`` runs
    it. ``warmup``: run it once untallied before the tallied run (a step
    that reads only its args); off for a case whose ``fn`` advances state
    it owns, such as a ``Simulation``'s steps, whose tallied run must start
    where the builder left it."""

    fn: Callable
    args: Tuple[Any, ...] = ()
    warmup: bool = True
    #: JXA503: the next step's args from (these args, this run's output);
    #: None: not a step
    carry: Optional[Callable[[Tuple[Any, ...], Any], Tuple[Any, ...]]] = None
    #: JXA402: a thunk returning the lowerdiff.KnobProbe comparisons this
    #: entry vouches for (the ``knob_inertness`` entry); None: the rule
    #: does not apply
    knob_probes: Optional[Callable[[], Any]] = None


@dataclasses.dataclass
class EntryPoint:
    """A registered auditable entry: declaration + lazy case builder."""

    name: str
    build: Callable[[], EntryCase]
    # JXA301 override: minimum attributed-FLOP share (None = the
    # AuditContext default)
    phase_coverage_min: Optional[float] = None
    # JXA302 override: per-entry budget file instead of the context default
    cost_budget_file: Optional[str] = None
    # JXA303: phases this entry DECLARES compute-bound
    expect_compute_bound: Tuple[str, ...] = ()
    # JXA105: bytes of host data made into one tensor, or of one device
    # tensor the run reads without getting or making it
    const_bytes_limit: int = 1 << 20
    # run with float64 as torch's default dtype (the JAX x64 switch: a
    # Python float then makes a float64 tensor; fixture use)
    x64: bool = False
    # statecheck's two-point probe: the same entry rebuilt larger (a
    # thunk returning its EntryCase); None: every axis is const
    grow: Optional[Callable[[], EntryCase]] = None
    # JXA104: the host syncs a run of this entry makes (reads of the card
    # on the host), declared where the code needs them
    host_syncs: int = 0
    path: str = "?"
    line: int = 0


def _display_path(filename: str) -> str:
    """cwd-relative posix path when possible, so that findings do not
    embed a checkout's absolute path."""
    p = Path(filename)
    try:
        return p.relative_to(Path.cwd()).as_posix()
    except ValueError:
        return p.as_posix()


def entrypoint(name: str, *, phase_coverage_min: Optional[float] = None,
               cost_budget_file: Optional[str] = None,
               expect_compute_bound: Tuple[str, ...] = (),
               const_bytes_limit: int = 1 << 20, x64: bool = False,
               grow: Optional[Callable[[], EntryCase]] = None,
               host_syncs: int = 0) -> Callable:
    """Decorator: declare a builder function as an audit entry point. The
    decorated function runs lazily (per audit run) and returns an
    ``EntryCase``; findings anchor at its definition line."""

    def deco(build: Callable[[], EntryCase]) -> EntryPoint:
        code = getattr(build, "__code__", None)
        return EntryPoint(
            name=name, build=build, phase_coverage_min=phase_coverage_min,
            cost_budget_file=cost_budget_file,
            expect_compute_bound=tuple(expect_compute_bound),
            const_bytes_limit=const_bytes_limit, x64=x64, grow=grow,
            host_syncs=host_syncs,
            path=_display_path(code.co_filename) if code else "?",
            line=code.co_firstlineno if code else 0,
        )

    return deco


def entries_from_namespace(ns: Dict[str, Any]) -> List[EntryPoint]:
    """Collect EntryPoint bindings from a module namespace, in source
    order."""
    entries = [v for v in ns.values() if isinstance(v, EntryPoint)]
    names = [e.name for e in entries]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"duplicate audit entry name(s): {sorted(dupes)}")
    return sorted(entries, key=lambda e: (e.path, e.line))


class EntryTrace:
    """Lazily computed, cached run artifacts of one entry: the tally of
    one run (``tally``, with its record ``tally.rows``), the run's output
    (``out``), the kernel launches it made (``launches``: the
    ``pair_engine.LAUNCHES`` delta over the tallied run) and the cost
    report the rules share (``costmodel.cost_report``)."""

    def __init__(self, entry: EntryPoint, case: EntryCase):
        self.entry = entry
        self.case = case
        self._tally = None
        self._out = None
        self.launches: Dict[str, int] = {}
        self.device = _case_device(case.args, audit_context().device)

    @property
    def tally(self):
        if self._tally is None:
            from sphexa_torch.devtools.audit.tally import tallying
            from sphexa_torch.sph.pair_engine import LAUNCHES

            if self.case.warmup:
                self.case.fn(*self.case.args)
            before = dict(LAUNCHES)
            with tallying(self.device, self.case.args, self.entry.x64) as t:
                out = self.case.fn(*self.case.args)
            self.launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                             if v != before.get(k, 0)}
            self._tally, self._out = t, out
        return self._tally

    @property
    def out(self):
        """The output of the tallied run."""
        self.tally  # noqa: B018 - runs the entry once
        return self._out

    def finding(self, rule: str, message: str) -> Finding:
        e = self.entry
        return Finding(rule=rule, path=e.path, line=e.line, col=0,
                       message=f"[{e.name}] {message}",
                       snippet=f"entry:{e.name}")


_TRACES: Dict[Tuple[str, str, str], EntryTrace] = {}


def entry_trace(entry: EntryPoint, device: Optional[str] = None) -> EntryTrace:
    """The process's one trace of ``entry`` built on ``device`` (default:
    the audit context's): built and run on first use, then shared by every
    mode of the CLI, the rules and the tests. A build that raises is not
    kept."""
    device = device or audit_context().device
    key = (entry.path, entry.name, device)
    trace = _TRACES.get(key)
    if trace is None:
        prev = set_audit_context(dataclasses.replace(audit_context(), device=device))
        try:
            trace = EntryTrace(entry, entry.build())
        finally:
            set_audit_context(prev)
        _TRACES[key] = trace
    return trace


def _case_device(args, default: str) -> str:
    """The device a case runs on: that of the first tensor in its args
    (looked for through tuples, lists, dicts and dataclasses such as a
    ``SimState``), else the context's."""
    import torch

    def find(obj, depth):
        if torch.is_tensor(obj):
            return obj.device.type
        if depth > 3:
            return None
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            items = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
        elif isinstance(obj, dict):
            items = list(obj.values())
        elif isinstance(obj, (list, tuple)):
            items = list(obj)
        else:
            return None
        for a in items:
            found = find(a, depth + 1)
            if found is not None:
                return found
        return None

    return find(args, 0) or default


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    description: str
    check: Callable[[EntryTrace], List[Finding]]


_REGISTRY: Dict[str, Rule] = {}


def register(id: str, name: str, description: str):
    """Decorator: register ``check(trace) -> [Finding]`` under a rule id."""

    def deco(fn: Callable[[EntryTrace], List[Finding]]):
        if id in _REGISTRY:
            raise ValueError(f"duplicate rule id {id}")
        _REGISTRY[id] = Rule(id=id, name=name, description=description, check=fn)
        return fn

    return deco


def all_rules() -> Dict[str, Rule]:
    # importing the rules package populates the registry
    import sphexa_torch.devtools.audit.rules  # noqa: F401

    return dict(_REGISTRY)


class Auditor:
    def __init__(self, select: Optional[Sequence[str]] = None):
        rules = all_rules()
        if select:
            unknown = set(select) - set(rules)
            if unknown:
                raise ValueError(f"unknown rule id(s): {sorted(unknown)}")
            rules = {k: v for k, v in rules.items() if k in select}
        self.rules = rules

    def check_entry(self, entry: EntryPoint, active: List[Finding],
                    errors: List[Finding], skipped: List[str]) -> Optional[EntryTrace]:
        """Build ``entry`` (``entry_trace``: once a process) and run every
        rule on it, appending to the lists; returns its trace, or None
        when it skipped, failed to build or a rule crashed (each a JXA000
        error but the skip)."""
        try:
            trace = entry_trace(entry)
        except EntrySkip as e:
            skipped.append(f"{entry.name}: {e}")
            return None
        except Exception as e:  # noqa: BLE001 - reported as JXA000
            errors.append(Finding(
                rule="JXA000", path=entry.path, line=entry.line, col=0,
                message=f"[{entry.name}] entry build failed: "
                        f"{e.__class__.__name__}: {e}",
            ))
            return None
        failed = False
        for rule in self.rules.values():
            try:
                found = rule.check(trace)
            except Exception as e:  # noqa: BLE001 - reported as JXA000
                tb = traceback.format_exc(limit=3)
                errors.append(Finding(
                    rule="JXA000", path=entry.path, line=entry.line, col=0,
                    message=f"[{entry.name}] {rule.id} crashed: "
                            f"{e.__class__.__name__}: {e}\n{tb}",
                ))
                failed = True
                continue
            active.extend(found)
        return None if failed else trace

    def run_entries(self, entries: Sequence[EntryPoint]
                    ) -> Tuple[List[Finding], List[Finding], List[str]]:
        """(active, errors, skipped) over the entries, each list sorted."""
        active: List[Finding] = []
        errors: List[Finding] = []
        skipped: List[str] = []
        for entry in entries:
            self.check_entry(entry, active, errors, skipped)
        key = lambda f: (f.path, f.line, f.rule, f.message)  # noqa: E731
        return sorted(active, key=key), sorted(errors, key=key), skipped
