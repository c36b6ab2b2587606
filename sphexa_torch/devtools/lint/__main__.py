"""``python -m sphexa_torch.devtools.lint``: the torchlint CLI."""

import sys

from sphexa_torch.devtools.lint.cli import main

sys.exit(main())
