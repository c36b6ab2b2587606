"""``python -m sphexa_torch.tuning``: the port's sweep driver."""

import sys

from sphexa_torch.tuning.cli import main

if __name__ == "__main__":
    sys.exit(main())
