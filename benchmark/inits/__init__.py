"""Initial conditions, made in numpy from the seed: ``<init>.py`` defines
``make(cfg, seed)``, which returns ``{"fields": {name: array}, "scalars":
{name: float}, "box": {"lo", "hi", "periodic"}}``. The same arrays go to
the port and to the reference."""

import importlib

import numpy as np


def make(cfg: dict, seed: int) -> dict:
    """The initial particles of configuration ``cfg`` for ``seed``."""
    mod = importlib.import_module(f"benchmark.inits.{cfg['init']}")
    return mod.make(cfg, seed)


def rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for ``seed`` (any whole number, negative and
    above 2**32 included) and a named stream, so that the initial
    conditions and the reference's samples draw from separate streams."""
    tag = int.from_bytes(stream.encode(), "little")
    return np.random.default_rng([int(seed) & (2**64 - 1), tag])
