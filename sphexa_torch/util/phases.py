"""The step's phase taxonomy (sphexa_tpu/util/phases.py) and the
``--debug-checks`` sanitizer that reports by it.

Every stage a profiler capture should attribute runs inside
``phase_scope(name)`` (or a function decorated ``@named_phase(name)``):
the step functions (propagator.py), the gravity solve, the neighbour
machinery, the halo exchange, the stirring and the cooling. While a
``torch.profiler`` capture runs, a scope is a
``record_function("sphexa/<phase>")`` range; telemetry/traceview.py
attributes the device time of a ``--trace-dir`` capture back to these
names. While a cost tally runs (devtools/audit/tally.py) a scope pushes
its phase onto the tally's stack. With no profiler running, no debug
checks active and no tally a scope is a null context: three flag reads
on the host and nothing the card sees, so the launches of a step are the
same with or without its scopes.

``debug_checks()`` (``Simulation(debug_checks=True)``, the CLI's
``--debug-checks``) is the port's form of the JAX package's checkify
sanitizer: inside it, ``check_finite`` reads the named outputs of a
stage and ``check_runs`` the index arrays a kernel is about to read, and
the first failure of the step (in step order) is kept as its message.
An out-of-bounds index inside a CUDA kernel is a device fault, not a
message, so the indices are checked in torch before the launch. Each
check reads the card; outside ``debug_checks()`` they return at once.
"""

import contextlib
import functools
from typing import List, Optional

import torch

#: every phase name (the JAX package's taxonomy, word for word); tests and
#: the trace reader key on these
PHASES = (
    "sort",             # SFC keygen + argsort + field permute, box regrow
    "neighbors",        # cell-table build / group windows / pair lists
    "halo-exchange",    # sparse/windowed halo negotiation + serves
    "density",          # std density pair op
    "xmass",            # VE generalized volume elements
    "gradh",            # VE kx / gradh pair op
    "eos",              # equation of state
    "iad",              # integral-approximation-of-derivatives tensor
    "divv-curlv",       # VE velocity divergence / curl (+gradv)
    "av-switches",      # VE artificial-viscosity switches
    "momentum-energy",  # momentum + energy pair op
    "gravity-upsweep",  # multipole upsweep (psum-reduced when sharded)
    "gravity-mac",      # MAC classification + interaction-list compaction
    "gravity-m2p",      # far-field multipole-to-particle evaluation
    "gravity-p2p",      # near-field particle-to-particle evaluation
    "cooling",          # radiative-cooling timestep + source integration
    "turbulence",       # OU stirring accelerations
    "timestep",         # dt candidate min-reduction + limiter attribution
    "dt-bins",          # block-timestep bin assignment, active compaction
    "integrate",        # drift/kick, PBC wrap, smoothing-length nudge
    "ledger",           # in-graph conservation/numerics science ledger
    "snapshot",         # in-graph downsampled field-grid deposit
    "shard-metrics",    # per-shard telemetry pack + gather
)

_PHASE_SET = frozenset(PHASES)

PREFIX = "sphexa/"

_NULL = contextlib.nullcontext()


class DebugChecks:
    """One step's sanitizer state: the phases open now (outermost first)
    and the first failure's message ("" while every check passed)."""

    def __init__(self):
        self.stack: List[str] = []
        self.error = ""

    @property
    def phase(self) -> str:
        return self.stack[0] if self.stack else "unscoped"


_DEBUG: Optional[DebugChecks] = None

#: the running cost tally (devtools/audit/tally.py ``Tally``, whose
#: ``stack`` holds the open phases), or None
_TALLY = None


def profiling() -> bool:
    """Whether a torch.profiler capture runs now (a flag read)."""
    return torch.autograd.profiler._is_profiler_enabled


def set_tally(tally):
    """Install ``tally`` as the running cost tally (None: none); returns
    the previous one."""
    global _TALLY
    prev, _TALLY = _TALLY, tally
    return prev


def active_tally():
    """The running cost tally, or None (a flag read)."""
    return _TALLY


class _Scope:
    def __init__(self, phase: str):
        self.phase = phase
        self.rf = None
        self.debug = None
        self.tally = None

    def __enter__(self):
        if profiling():
            self.rf = torch.profiler.record_function(PREFIX + self.phase)
            self.rf.__enter__()
        self.debug = _DEBUG
        if self.debug is not None:
            self.debug.stack.append(self.phase)
        self.tally = _TALLY
        if self.tally is not None:
            self.tally.stack.append(self.phase)
        return self

    def __exit__(self, *exc):
        if self.tally is not None:
            self.tally.stack.pop()
        if self.debug is not None:
            self.debug.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def phase_scope(phase: str):
    """The scope of one taxonomy phase (asserted against PHASES, so a typo
    cannot open a new bucket): a profiler range, a debug-check frame and a
    cost tally's phase where any is on, else a null context."""
    assert phase in _PHASE_SET, f"unknown phase {phase!r} (util/phases.PHASES)"
    if _DEBUG is None and _TALLY is None and not profiling():
        return _NULL
    return _Scope(phase)


def named_phase(phase: str):
    """Decorator form of ``phase_scope``: the wrapped function runs inside
    the phase's scope."""
    assert phase in PHASES, f"unknown phase {phase!r} (util/phases.PHASES)"

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _DEBUG is None and _TALLY is None and not profiling():
                return fn(*args, **kwargs)
            with _Scope(phase):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def debug_checks():
    """Run the enclosed step under the sanitizer; yields its
    ``DebugChecks`` (``.error`` holds the first failure, "" when clean)."""
    global _DEBUG
    prev, _DEBUG = _DEBUG, DebugChecks()
    try:
        yield _DEBUG
    finally:
        _DEBUG = prev


def debug_active() -> bool:
    return _DEBUG is not None


def check_finite(phase: str, **fields) -> None:
    """Under ``debug_checks()``: the first NaN or Inf among ``fields``
    (tensors by name; None and integer tensors are skipped) becomes the
    step's failure, named by ``phase`` and the field. A no-op otherwise,
    or once the step has failed."""
    d = _DEBUG
    if d is None or d.error:
        return
    assert phase in PHASES, f"unknown phase {phase!r} (util/phases.PHASES)"
    for name, t in fields.items():
        if t is None or not torch.is_tensor(t) or not t.is_floating_point():
            continue
        nan = int(torch.isnan(t).sum())
        inf = int(torch.isinf(t).sum())
        if nan or inf:
            kind = "nan" if nan else "inf"
            d.error = (f"{kind} generated in phase {phase!r}: {name} "
                       f"({nan + inf} of {t.numel()} values not finite)")
            return


def check_runs(name: str, starts, lens, size: int) -> None:
    """Under ``debug_checks()``: the live runs ``[starts, starts + lens)``
    (``lens`` > 0) of an index table a kernel reads must lie in
    ``[0, size)``; the first that does not becomes the step's failure,
    named by the phase open now. A no-op otherwise."""
    d = _DEBUG
    if d is None or d.error:
        return
    live = lens > 0
    s = starts.to(torch.int64)
    end = s + lens.to(torch.int64)
    lo = int(torch.where(live, s, torch.zeros_like(s)).min()) if s.numel() else 0
    hi = int(torch.where(live, end, torch.zeros_like(end)).max()) if s.numel() else 0
    neg = int((lens < 0).sum())
    if lo < 0 or hi > size or neg:
        d.error = (f"out-of-bounds index in phase {d.phase!r}: the runs of {name} span "
                   f"rows [{lo}, {hi}) of {size}"
                   + (f", {neg} negative lengths" if neg else ""))

