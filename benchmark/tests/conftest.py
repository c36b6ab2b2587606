"""The benchmark's own tests: run them from the root of the repository
with ``python -m pytest benchmark/tests -q`` (the repository's ``tests/``
run does not collect them). The ``gpu`` ones skip without a CUDA card."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
