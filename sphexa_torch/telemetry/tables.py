"""Plain-text tables of the port's CLIs: ``render_table`` of
sphexa_torch/devtools/common.py, the port's one copy."""

from sphexa_torch.devtools.common import render_table

__all__ = ["render_table"]
