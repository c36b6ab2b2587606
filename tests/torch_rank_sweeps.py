"""The rank function of tests/test_torch_tuning.py's sweep over two gloo
ranks. ``parallel.mesh.spawn`` imports it by name in each rank, so it
lives in a module of its own that imports no JAX."""

from sphexa_torch.tuning import replay
from sphexa_torch.tuning.search import run_sweep


def sweep_and_fault(mesh, spec, domains, budget, steps, fault_knobs):
    """This rank's sweep as ``replay.sweep_on_ranks`` runs it, then the
    same sweep again with ``measure_candidate`` raising on rank 1 alone
    for ``fault_knobs`` (under ``"faulted"``), once the candidate's run
    and its collectives are done on every rank."""
    out = replay._sweep_rank(mesh, spec, domains, budget, steps, 1, "per_step_s", None)
    real = replay.measure_candidate

    def flaky(spec_, knobs, **kw):
        out = real(spec_, knobs, **kw)
        if mesh.rank == 1 and knobs == fault_knobs:
            raise RuntimeError("rank 1 only")
        return out

    replay.measure_candidate = flaky
    try:
        out["faulted"] = run_sweep(replay.rank_measure(mesh, spec, steps, 1), domains, budget)
    finally:
        replay.measure_candidate = real
    return out
