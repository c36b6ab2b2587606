"""Initial conditions of the port (sphexa_tpu/init): the Sedov, Noh,
Gresho-Chan, Evrard, turbulence and Evrard-cooling cases, restart from a
snapshot file, and the case factory ``make_initializer`` keyed by the
reference CLI's names."""

import functools
import json
from typing import Callable, Dict

from sphexa_torch.init.evrard import init_evrard, init_evrard_cooling
from sphexa_torch.init.gresho_chan import init_gresho_chan
from sphexa_torch.init.noh import init_noh
from sphexa_torch.init.sedov import init_sedov, jitter_sedov, stretch_box
from sphexa_torch.init.turbulence import init_turbulence

# case name -> init function: the ported cases of the JAX package's CASES
CASES: Dict[str, Callable] = {
    "sedov": init_sedov,
    "noh": init_noh,
    "evrard": init_evrard,
    "gresho-chan": init_gresho_chan,
    "turbulence": init_turbulence,
    "evrard-cooling": init_evrard_cooling,
}

#: every case name of the JAX package (the reference's --init choices,
#: factory.hpp:59-100), the ported ones included
JAX_CASE_NAMES = ("sedov", "noh", "evrard", "gresho-chan", "isobaric-cube",
                  "kelvin-helmholtz", "wind-shock", "turbulence", "evrard-cooling")


def split_case_spec(name: str):
    """'case:settings.json' -> (case, settings_path); otherwise (name, None).
    The one parse of the spec grammar: the CLI keys observables and dump
    metadata on it too."""
    if ":" in name:
        case, _, settings_path = name.partition(":")
        if case in CASES:
            return case, settings_path
    return name, None


def make_initializer(name: str) -> Callable:
    """The initializer for a case name, 'case:settings.json' (the JSON
    object's keys override the case's settings), 'path,N' (a snapshot
    up-sampled N-fold) or 'path[:step]' (restart from a snapshot). Each
    returned callable takes (side, device=...). A case of the JAX package
    that is not ported raises NotImplementedError; any other name raises
    ValueError, as the JAX package's does."""
    if name in CASES:
        return CASES[name]

    case, settings_path = split_case_spec(name)
    if settings_path is not None:
        try:
            with open(settings_path) as f:
                overrides = json.load(f)
        except OSError as e:
            raise ValueError(f"cannot read settings file {settings_path}: {e}")
        except json.JSONDecodeError as e:
            raise ValueError(f"invalid JSON in {settings_path}: {e}")
        if not isinstance(overrides, dict):
            raise ValueError(f"{settings_path} must hold a JSON object")
        return functools.partial(CASES[case], overrides=overrides)

    from sphexa_torch.init.file_init import (
        init_file_split, init_from_file, looks_like_file, parse_split_spec,
    )

    split = parse_split_spec(name)
    if split is not None and looks_like_file(split[0]):
        return functools.partial(init_file_split, split[0], split[1])
    if looks_like_file(name):
        return functools.partial(init_from_file, name)
    if name in JAX_CASE_NAMES:
        raise NotImplementedError(
            f"--init {name!r}: not ported yet (the ported cases are {sorted(CASES)}, "
            "'case:settings.json', 'file,N' splitting and an existing snapshot file)")
    raise ValueError(
        f"unknown test case '{name}' (not a case name in {sorted(JAX_CASE_NAMES)}, "
        "not 'case:settings.json', not 'file,N' splitting, and not an existing "
        "snapshot file)")


__all__ = ["CASES", "make_initializer", "split_case_spec", "init_evrard",
           "init_evrard_cooling", "init_gresho_chan", "init_noh", "init_sedov",
           "init_turbulence", "jitter_sedov", "stretch_box"]
