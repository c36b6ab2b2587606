"""torchlint: the port's AST lint (the JAX package's jaxlint,
sphexa_tpu/devtools/lint), its four rules with a torch meaning:

- JXL001  a tensor built at import time (module body, class body, default
          argument): it pins a device before ``--device`` is parsed
- JXL002  a host sync in step code (lint/scope.py: the functions the
          audit registry's step entries run, and their same-module callees)
- JXL003  a literal torch dtype where sphexa_torch/dtypes.py names the
          policy (init/, sfc/, io/, sph/particles.py)
- JXL006  a torch.distributed collective outside parallel/mesh.py and
          parallel/exchange.py

jaxlint's JXL004 (Pallas tiles), JXL005 (jit static arguments) and JXL007
(pytree registration) have no torch meaning.

Usage::

    python -m sphexa_torch.devtools.lint [paths]     (default: sphexa_torch)
    sphexa-torch-lint sphexa_torch --format json

Suppress one finding with an inline comment that gives its reason::

    n = int(total)  # torchlint: disable=JXL002 -- the buffer's size

The lint's own modules use only the standard library (``ast`` and
``tokenize``) and never import the code they scan. Running it as
``python -m`` imports the ``sphexa_torch`` package's ``__init__``, which
imports torch.
"""

from sphexa_torch.devtools.lint.core import (  # noqa: F401
    Analyzer,
    Finding,
    ModuleInfo,
    Rule,
    all_rules,
    lint_paths,
)
