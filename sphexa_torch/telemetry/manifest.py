"""Run manifest (sphexa_tpu/telemetry/manifest.py): the who/what/where
stamp that makes runs comparable, ``manifest.json`` next to
``events.jsonl``. The keys and ``MANIFEST_SCHEMA`` are the JAX package's
except the backend block, which names torch, CUDA and the card instead
of the jax version, so the JAX package's ``sphexa-telemetry`` reads a
port run directory."""

import datetime
import json
import os
import subprocess
import sys
from typing import Dict, Optional

import torch

from sphexa_torch.telemetry.registry import SCHEMA_VERSION

#: manifest schema version (independent of the event schema)
MANIFEST_SCHEMA = 1


def git_rev() -> str:
    """Short git revision of the source tree, or 'unknown' outside a
    checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "-C", root, "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def backend_block(device=None) -> Dict:
    """torch and CUDA versions, the run's backend ("cuda" or "cpu"), the
    card's name and the CUDA device count."""
    dev = torch.device(device) if device is not None else None
    on_card = dev is not None and dev.type == "cuda"
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": dev.type if dev is not None else "unknown",
        "device_name": torch.cuda.get_device_name(dev) if on_card else None,
        "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
    }


def build_manifest(config: Optional[Dict] = None, particles: Optional[int] = None,
                   mesh_shape=None, extra: Optional[Dict] = None, device=None) -> Dict:
    """Assemble the manifest dict; ``device`` is the run's device."""
    return {
        "schema": MANIFEST_SCHEMA,
        "events_schema": SCHEMA_VERSION,
        "created": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "git_rev": git_rev(),
        **backend_block(device),
        "mesh_shape": list(mesh_shape) if mesh_shape is not None else None,
        "python": sys.version.split()[0],
        "platform": sys.platform,
        "particles": int(particles) if particles is not None else None,
        "config": config or {},
        **(extra or {}),
    }


def write_manifest(run_dir: str, **kwargs) -> Dict:
    """Build and write ``<run_dir>/manifest.json``; returns the dict."""
    manifest = build_manifest(**kwargs)
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
        f.write("\n")
    return manifest


def read_manifest(run_dir: str) -> Optional[Dict]:
    path = os.path.join(run_dir, "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
