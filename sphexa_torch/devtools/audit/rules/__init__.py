"""Rule modules register themselves on import (core.register): the cost
rules JXA301-JXA303, under the JAX package's ids."""

from sphexa_torch.devtools.audit.rules import (  # noqa: F401
    jxa301_phase_coverage,
    jxa302_cost_budget,
    jxa303_memory_bound,
)
