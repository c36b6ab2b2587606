"""Semi-analytic solutions and the L1 comparison (sphexa_tpu/analysis):
the Sedov-Taylor solution, the Noh implosion, the Gresho-Chan vortex and
the Evrard collapse's normalized profiles (numpy copies), and the output
fields the comparison reads, recomputed by the port's pair engine."""

from sphexa_torch.analysis.compare import compute_output_fields, l1_error, output_fields
from sphexa_torch.analysis.noh import noh_solution
from sphexa_torch.analysis.sedov import sedov_solution

__all__ = ["noh_solution", "sedov_solution", "compute_output_fields", "output_fields",
           "l1_error"]
