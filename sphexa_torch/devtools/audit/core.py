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
- A sharded entry (``mesh_axes``: the port's one axis ``"p"``, the
  mesh's group) is P rank processes, each running its slab of the entry:
  ``run_sharded`` starts ``mesh_size`` ranks once (``parallel.mesh.spawn``:
  gloo with ``--cpu``, NCCL where the machine has P cards, else gloo ranks
  sharing the card) for every sharded entry of a run not recorded yet;
  each rank builds the entry (``audit_mesh()`` is its Mesh), runs it once
  untallied and once under the tally, and sends back its record
  (``RankRun``: the Tally, which pickles without its weak maps, the
  outputs, args and carry on the host, the launches, the card's peak
  allocation, and the grow probe's record). A ``ShardedTrace`` holds the
  P records; the rules that read one record run on every rank's
  (``RankView``), the SPMD rules (JXA106, JXA201-JXA204) compare them.

``JXA000`` is reserved for entries whose build or run raises: a broken
registry entry can never silently shrink coverage.
"""

import dataclasses
import importlib
import importlib.util
import os
import sys
import tempfile
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

def _card_memory() -> int:
    from sphexa_torch.devtools.audit.devices import get_device

    return get_device("h100").memory_bytes


@dataclasses.dataclass(frozen=True)
class AuditContext:
    """Process-wide knobs the rules and the registry read."""

    #: where the registry's entries build their state and run: "cuda" (the
    #: card, the default of every entry point of the port) or "cpu"
    device: str = "cuda"
    #: the ranks a sharded entry runs on (the CLI's modes 2, ``preflight
    #: --mesh P``)
    mesh_size: int = 2
    #: JXA202's campaign: particles and ranks (one 8-card H100 node)
    campaign_n: int = 64_000_000
    campaign_devices: int = 8
    #: JXA202's per-rank budget (``--hbm-budget``; an entry's ``hbm_budget``
    #: wins): the card's memory, devices.py's h100
    hbm_budget_bytes: int = dataclasses.field(default_factory=_card_memory)
    #: JXA203: a collective result holding every rank's rows of a particle
    #: field above this many bytes at campaign size
    repl_threshold_bytes: int = 1 << 20
    #: JXA204: growth of the non-extensive bytes allowed over linear in N
    tree_growth_slack: float = 1.25
    #: JXA203: the measured exchange allowed over the declared budget
    exchange_slack: float = 2.0
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
    #: JXA203: the analytic bytes a rank's collectives ship in a run (the
    #: JAX builder's budget, sizing-derived, headroom included); None: no
    #: volume gate
    exchange_budget_bytes: Optional[int] = None
    #: JXA203: the bytes of the port's distributed sort where the entry
    #: runs it and the JAX entry does not (its all_to_all and its counts),
    #: gated with the budget
    sort_bytes: int = 0


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
    # the mesh axes the entry's collectives may run over: ("p",) runs it
    # on ``mesh_size`` ranks; () is a one-device entry (no collective)
    mesh_axes: Tuple[str, ...] = ()
    # JXA202: this entry's per-rank memory budget (None: the context's)
    hbm_budget: Optional[int] = None
    path: str = "?"
    line: int = 0
    # where a rank loads the entry from: the builder's module and file
    module: str = ""
    filename: str = ""


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
               host_syncs: int = 0, mesh_axes: Tuple[str, ...] = (),
               hbm_budget: Optional[int] = None) -> Callable:
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
            host_syncs=host_syncs, mesh_axes=tuple(mesh_axes), hbm_budget=hbm_budget,
            path=_display_path(code.co_filename) if code else "?",
            line=code.co_firstlineno if code else 0,
            module=getattr(build, "__module__", "") or "",
            filename=os.path.abspath(code.co_filename) if code else "",
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
    ``pair_engine.LAUNCHES`` delta over the tallied run), the grow probe's
    run (``grown``) and the cost report the rules share
    (``costmodel.cost_report``). ``ranks``: the records the SPMD rules
    compare, this trace's own on one device."""

    sharded = False
    rank = 0
    #: the card's peak allocation over the tallied run (a rank's record)
    max_allocated: Optional[int] = None

    def __init__(self, entry: EntryPoint, case: EntryCase):
        self.entry = entry
        self.case = case
        self._tally = None
        self._out = None
        self._grown = None
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
            t.finish(out)
            self.launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                             if v != before.get(k, 0)}
            self._tally, self._out = t, out
        return self._tally

    @property
    def out(self):
        """The output of the tallied run."""
        self.tally  # noqa: B018 - runs the entry once
        return self._out

    @property
    def ranks(self) -> List["EntryTrace"]:
        return [self]

    def grown(self) -> Optional["EntryTrace"]:
        """The entry rebuilt by its grow probe (statecheck's second point,
        JXA204's), built and run once; None without a probe."""
        if self.entry.grow is None:
            return None
        if self._grown is None:
            prev = set_audit_context(dataclasses.replace(audit_context(), device=self.device))
            try:
                case = self.entry.grow()
            finally:
                set_audit_context(prev)
            self._grown = EntryTrace(EntryPoint(name=self.entry.name, build=lambda: case),
                                     case)
        return self._grown

    def finding(self, rule: str, message: str) -> Finding:
        e = self.entry
        return Finding(rule=rule, path=e.path, line=e.line, col=0,
                       message=f"[{e.name}] {message}",
                       snippet=f"entry:{e.name}")


# ---------------------------------------------------------------------------
# sharded entries: P rank processes, one record each
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RankRun:
    """One rank's record of a sharded entry (picklable): the Tally of its
    run, its outputs, args and carry (``next_args``) on the host, its
    launches, the case's declared exchange budget and sort bytes, the
    card's peak allocation over the tallied run (its statistics reset
    before it) and what was allocated at that reset (None on the CPU), the
    grow probe's record, or the skip or error that stopped the build."""

    rank: int
    tally: Any = None
    out: Any = None
    args: Tuple[Any, ...] = ()
    next_args: Any = None
    has_carry: bool = False
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    exchange_budget_bytes: Optional[int] = None
    sort_bytes: int = 0
    max_allocated: Optional[int] = None
    allocated_before: Optional[int] = None
    grown: Optional["RankRun"] = None
    skip: Optional[str] = None
    error: Optional[str] = None


class RankView(EntryTrace):
    """One rank's record as a trace: what the one-record rules read."""

    sharded = False

    def __init__(self, entry: EntryPoint, run: RankRun, device: str):
        carry = (lambda _args, _out: run.next_args) if run.has_carry else None
        case = EntryCase(fn=None, args=run.args, warmup=False, carry=carry,
                         exchange_budget_bytes=run.exchange_budget_bytes,
                         sort_bytes=run.sort_bytes)
        self.entry, self.case, self.device, self.run = entry, case, device, run
        self.rank = run.rank
        self._tally, self._out, self._grown = run.tally, run.out, None
        self.launches = dict(run.launches)
        self.max_allocated = run.max_allocated

    def grown(self) -> Optional[EntryTrace]:
        if self.run.grown is None:
            return None
        if self._grown is None:
            self._grown = RankView(self.entry, self.run.grown, self.device)
        return self._grown


class ShardedTrace(EntryTrace):
    """A sharded entry's P records (``ranks``, rank order); ``tally``,
    ``out`` and ``launches`` are rank 0's."""

    sharded = True

    def __init__(self, entry: EntryPoint, runs: List[RankRun], device: str, mesh_size: int):
        self.entry, self.device, self.mesh_size = entry, device, mesh_size
        self._ranks = [RankView(entry, r, device) for r in runs]
        first = self._ranks[0]
        self.case, self._tally, self._out = first.case, first._tally, first._out
        self.launches, self._grown = first.launches, None

    @property
    def ranks(self) -> List[EntryTrace]:
        return list(self._ranks)

    def grown(self) -> Optional[EntryTrace]:
        return self._ranks[0].grown()


_MESH = None


def audit_mesh():
    """The Mesh of the rank a sharded entry is being built in."""
    if _MESH is None:
        raise RuntimeError("no audit mesh: a sharded entry builds inside the ranks that "
                           "core.run_sharded starts")
    return _MESH


def _host_copy(obj):
    """``obj`` with every tensor detached onto the host (to leave a rank)."""
    import torch

    from sphexa_torch.devtools.audit.statecheck import flatten, unflatten

    leaves = [v.detach().cpu() if isinstance(v, torch.Tensor) else v for _p, v in flatten(obj)]
    return unflatten(obj, leaves)


def _record(entry: EntryPoint, case: EntryCase, device: str, rank: int) -> RankRun:
    """Run ``case`` untallied (when it warms up) and once under the tally."""
    import torch

    from sphexa_torch.devtools.audit.tally import tallying
    from sphexa_torch.sph.pair_engine import LAUNCHES

    if case.warmup:
        case.fn(*case.args)
    cuda = device == "cuda"
    resident = None
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = int(torch.cuda.memory_allocated())
    before = dict(LAUNCHES)
    with tallying(device, case.args, entry.x64) as t:
        out = case.fn(*case.args)
    t.finish(out)
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    launches = {k: v - before.get(k, 0) for k, v in LAUNCHES.items() if v != before.get(k, 0)}
    nxt = _host_copy(case.carry(case.args, out)) if case.carry is not None else None
    return RankRun(rank=rank, tally=t, out=_host_copy(out), args=_host_copy(case.args),
                   next_args=nxt, has_carry=case.carry is not None, launches=launches,
                   exchange_budget_bytes=case.exchange_budget_bytes,
                   sort_bytes=case.sort_bytes, max_allocated=peak,
                   allocated_before=resident)


def _load_entry(module: str, filename: str, name: str) -> EntryPoint:
    """The entry ``name`` of the registry module ``module`` (from
    ``filename`` when the module is not importable under that name)."""
    mod = None
    try:
        mod = importlib.import_module(module)
    except ImportError:
        pass
    if mod is None or os.path.abspath(getattr(mod, "__file__", "") or "") != filename:
        spec = importlib.util.spec_from_file_location(Path(filename).stem, filename)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    for e in entries_from_namespace(vars(mod)):
        if e.name == name:
            return e
    raise ValueError(f"no entry {name!r} in {filename}")


def _rank_main(mesh, jobs, ctx: AuditContext) -> List[RankRun]:
    """A rank of ``run_sharded``: each job's entry built on this rank's
    slab and recorded (``_record``), its grow probe too."""
    global _MESH
    _MESH = mesh
    device = mesh.device.type
    set_audit_context(dataclasses.replace(ctx, device=device))
    runs = []
    for module, filename, name in jobs:
        try:
            entry = _load_entry(module, filename, name)
            run = _record(entry, entry.build(), device, mesh.rank)
            if entry.grow is not None:
                run.grown = _record(entry, entry.grow(), device, mesh.rank)
        except EntrySkip as e:
            run = RankRun(rank=mesh.rank, skip=str(e))
        except Exception:  # noqa: BLE001 - reported by the parent
            run = RankRun(rank=mesh.rank, error=traceback.format_exc(limit=8))
        runs.append(run)
    return runs


def rank_launch(device: str, nprocs: int) -> Dict[str, Any]:
    """``spawn``'s backend, device and threads for ``nprocs`` ranks on
    ``device``: gloo on the CPU (one torch thread a rank), NCCL where the
    machine has a card a rank, else gloo ranks sharing the card."""
    import torch

    if device == "cpu":
        return {"device": "cpu", "backend": "gloo", "threads": 1}
    if torch.cuda.device_count() >= nprocs:
        return {"device": None, "backend": None, "threads": None}
    return {"device": None, "backend": "gloo", "threads": None}


#: sharded records by (path, name, device, P): the rank runs, or the
#: exception that stopped their spawn
_SHARDED: Dict[Tuple[str, str, str, int], Any] = {}

#: seconds a spawn of the ranks may take (a rank stuck in a collective
#: whose peer failed is stopped there)
RANK_TIMEOUT = 900.0


def run_sharded(entries: Sequence[EntryPoint], device: Optional[str] = None,
                mesh_size: Optional[int] = None) -> None:
    """Record every sharded entry of ``entries`` not yet recorded on
    ``device`` at ``mesh_size`` ranks (default: the context's), in one
    spawn of the ranks. Calls for other devices or sizes may run at once
    (threads): each reads the context only here."""
    from sphexa_torch.parallel.mesh import spawn

    ctx = audit_context()
    device = device or ctx.device
    P = mesh_size or ctx.mesh_size
    todo = [e for e in entries if e.mesh_axes
            and (e.path, e.name, device, P) not in _SHARDED]
    if not todo:
        return
    jobs = [(e.module, e.filename, e.name) for e in todo]
    try:
        with tempfile.TemporaryDirectory(prefix="sphexa-audit-") as wd:
            out = spawn(_rank_main, P, args=(jobs, dataclasses.replace(ctx, device=device,
                                                                       mesh_size=P)),
                        workdir=wd, timeout=RANK_TIMEOUT, **rank_launch(device, P))
    except Exception as e:  # noqa: BLE001 - each entry reports it
        for entry in todo:
            _SHARDED[(entry.path, entry.name, device, P)] = e
        return
    for i, entry in enumerate(todo):
        _SHARDED[(entry.path, entry.name, device, P)] = [o[i] for o in out]


def _sharded_trace(entry: EntryPoint, device: str) -> ShardedTrace:
    P = audit_context().mesh_size
    run_sharded([entry], device)
    runs = _SHARDED[(entry.path, entry.name, device, P)]
    if isinstance(runs, Exception):
        raise RuntimeError(f"the {P} ranks failed: {runs.__class__.__name__}: {runs}")
    skips = [r.skip for r in runs if r.skip]
    if skips:
        raise EntrySkip(skips[0])
    for r in runs:
        if r.error:
            raise RuntimeError(f"rank {r.rank} of {P}: {r.error.strip().splitlines()[-1]}\n"
                               f"{r.error}")
    return ShardedTrace(entry, runs, device, P)


_TRACES: Dict[Tuple[str, str, str, int], EntryTrace] = {}


def entry_trace(entry: EntryPoint, device: Optional[str] = None) -> EntryTrace:
    """The process's one trace of ``entry`` built on ``device`` (default:
    the audit context's): built and run on first use, then shared by every
    mode of the CLI, the rules and the tests; a sharded entry's at the
    context's mesh size (``run_sharded``). A build that raises is not
    kept."""
    device = device or audit_context().device
    P = audit_context().mesh_size if entry.mesh_axes else 1
    key = (entry.path, entry.name, device, P)
    trace = _TRACES.get(key)
    if trace is None:
        if entry.mesh_axes:
            trace = _sharded_trace(entry, device)
        else:
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
    #: reads every rank's record (``trace.ranks``) at once; the other
    #: rules read one record and run on each rank's of a sharded entry
    spmd: bool = False


_REGISTRY: Dict[str, Rule] = {}


def register(id: str, name: str, description: str, spmd: bool = False):
    """Decorator: register ``check(trace) -> [Finding]`` under a rule id
    (``spmd``: it compares the ranks' records of ``trace.ranks``)."""

    def deco(fn: Callable[[EntryTrace], List[Finding]]):
        if id in _REGISTRY:
            raise ValueError(f"duplicate rule id {id}")
        _REGISTRY[id] = Rule(id=id, name=name, description=description, check=fn,
                             spmd=spmd)
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
        error but the skip). On a sharded entry a one-record rule runs on
        every rank's record, a finding the ranks share once."""
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
            targets = trace.ranks if trace.sharded and not rule.spmd else [trace]
            found: List[Finding] = []
            try:
                for t in targets:
                    found += [f for f in rule.check(t) if f not in found]
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
        """(active, errors, skipped) over the entries, each list sorted; the
        sharded entries recorded in one spawn of the ranks."""
        active: List[Finding] = []
        errors: List[Finding] = []
        skipped: List[str] = []
        run_sharded(entries)
        for entry in entries:
            self.check_entry(entry, active, errors, skipped)
        key = lambda f: (f.path, f.line, f.rule, f.message)  # noqa: E731
        return sorted(active, key=key), sorted(errors, key=key), skipped
