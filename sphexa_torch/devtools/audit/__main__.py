"""``python -m sphexa_torch.devtools.audit`` entry point."""

import sys

from sphexa_torch.devtools.audit.cli import main

sys.exit(main())
