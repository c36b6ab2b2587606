"""Initial conditions of the port (sphexa_tpu/init): every case of the
JAX package (Sedov, Noh, Gresho-Chan, Evrard, isobaric cube,
Kelvin-Helmholtz, wind shock, turbulence, Evrard-cooling), restart from a
snapshot file, and the case factory ``make_initializer`` keyed by the
reference CLI's names."""

import functools
import json
from typing import Callable, Dict

from sphexa_torch.init.evrard import init_evrard, init_evrard_cooling
from sphexa_torch.init.gresho_chan import init_gresho_chan
from sphexa_torch.init.isobaric_cube import init_isobaric_cube
from sphexa_torch.init.kelvin_helmholtz import init_kelvin_helmholtz
from sphexa_torch.init.noh import init_noh
from sphexa_torch.init.sedov import init_sedov, jitter_sedov, stretch_box
from sphexa_torch.init.turbulence import init_turbulence
from sphexa_torch.init.wind_shock import init_wind_shock

# case name -> init function: the JAX package's CASES, the reference's
# --init choices (factory.hpp:59-100)
CASES: Dict[str, Callable] = {
    "sedov": init_sedov,
    "noh": init_noh,
    "evrard": init_evrard,
    "gresho-chan": init_gresho_chan,
    "isobaric-cube": init_isobaric_cube,
    "kelvin-helmholtz": init_kelvin_helmholtz,
    "wind-shock": init_wind_shock,
    "turbulence": init_turbulence,
    "evrard-cooling": init_evrard_cooling,
}


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
    returned callable takes (side, device=...). Any other name raises
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
    raise ValueError(
        f"unknown test case '{name}' (not a case name in {sorted(CASES)}, "
        "not 'case:settings.json', not 'file,N' splitting, and not an existing "
        "snapshot file)")


__all__ = ["CASES", "make_initializer", "split_case_spec", "init_evrard",
           "init_evrard_cooling", "init_gresho_chan", "init_isobaric_cube",
           "init_kelvin_helmholtz", "init_noh", "init_sedov", "init_turbulence",
           "init_wind_shock", "jitter_sedov", "stretch_box"]
