"""Rule modules register themselves on import (core.register), under the
JAX package's ids: the trace rules JXA101, JXA104, JXA105 and JXA106, the
SPMD rules JXA201-JXA204, the cost rules JXA301-JXA303, determinism and
knob inertness JXA401-JXA402, and statecheck JXA501-JXA503."""

from sphexa_torch.devtools.audit.rules import (  # noqa: F401
    jxa101_dtype_promotion,
    jxa104_host_boundary,
    jxa105_const_bloat,
    jxa106_collective_axes,
    jxa201_collective_order,
    jxa202_peak_hbm,
    jxa203_sharding_propagation,
    jxa204_tree_growth,
    jxa301_phase_coverage,
    jxa302_cost_budget,
    jxa303_memory_bound,
    jxa401_nondeterminism,
    jxa402_knob_inertness,
    jxa501_schema_drift,
    jxa502_vmap,
    jxa503_carry_closure,
)
