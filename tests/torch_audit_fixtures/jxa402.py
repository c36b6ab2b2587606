"""JXA402 fixtures: a knob spec whose off sentinel perturbs the step
(``dt_bins=4`` turns the block time steps on: fires) and one whose
sentinel is inert (``dt_bins=None``: clean), probed against the
registry's std step (lowerdiff.knob_probes)."""

from sphexa_torch.devtools.audit.core import EntryCase, entrypoint
from sphexa_torch.tuning.knobs import COST_STATIC, KnobSpec


def _probes(off):
    from sphexa_torch.devtools.audit import registry
    from sphexa_torch.devtools.audit.lowerdiff import knob_probes

    spec = KnobSpec("dt_bins", "PropagatorConfig", "dt_bins", (2, 4), COST_STATIC,
                    "fixture", off_sentinel=off)
    return lambda: knob_probes([spec], {"std": registry.step_std})


def _case(off):
    import torch

    return EntryCase(fn=lambda x: x * 1.0, args=(torch.ones(8),), knob_probes=_probes(off))


@entrypoint("jxa402_fires", phase_coverage_min=0.0)
def jxa402_fires():
    return _case(4)


@entrypoint("jxa402_clean", phase_coverage_min=0.0)
def jxa402_clean():
    return _case(None)
