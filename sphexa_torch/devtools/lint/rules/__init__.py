"""Rule modules register themselves on import (core.register)."""

from sphexa_torch.devtools.lint.rules import (  # noqa: F401
    jxl001_import_tensors,
    jxl002_host_sync,
    jxl003_dtype_policy,
    jxl006_collectives,
)
