"""Wall-clock phase timing and the profile series
(sphexa_tpu/util/timer.py): thin names over the registry's
implementations (telemetry/registry.py ``LapTimer`` and ``StepSeries``),
so that laps recorded here also accumulate in a shared ``Telemetry``.

The reference's counterpart is ``main/src/util/timer.hpp`` (a Timer per
substep printed each iteration, dumped as a series with --profile,
ipropagator.hpp:80-119); the CLI's laps are coarser (step, observables,
output), and ``util/substep_profile.py`` splits the step itself."""

from sphexa_torch.telemetry.registry import LapTimer, StepSeries


class Timer(LapTimer):
    """Accumulates named wall-clock laps within one iteration
    (``step(name)`` records since the last mark, timer.hpp:46); pass
    ``telemetry=`` to mirror every lap into a registry."""


class ProfileRecorder(StepSeries):
    """Per-iteration timing and metric rows, saved with --profile
    (ipropagator.hpp:83-87 writes the analogous HDF5 series). ``save``
    returns whether a file was written."""
