"""``python -m sphexa_torch.telemetry``: the port's telemetry reader."""

import sys

from sphexa_torch.telemetry.cli import main

if __name__ == "__main__":
    sys.exit(main())
