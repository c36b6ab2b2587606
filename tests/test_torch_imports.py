"""The port stands alone: no module of sphexa_torch, and not chip_smoke.py,
imports JAX or the JAX package (an AST scan: a sys.modules check would be
fooled by interpreters that import jax at start-up)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "sphexa_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, files in os.walk(os.path.join(ROOT, "sphexa_torch")):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_port_sources_found():
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert "chip_smoke.py" in names
    for mod in (("sph", "pair_engine.py"), ("sph", "pair_lists.py"),
                ("sph", "hydro_ve.py"), ("init", "noh.py"), ("init", "glass.py"),
                ("init", "gresho_chan.py"), ("init", "evrard.py"),
                ("gravity", "traversal.py"), ("gravity", "pallas_compact.py"),
                ("gravity", "multipole.py"), ("gravity", "tree.py"), ("gravity", "direct.py"),
                ("parallel", "sizing.py"), ("tree", "csarray.py"), ("state.py",),
                ("telemetry", "registry.py"), ("telemetry", "sinks.py"),
                ("observables", "ledger.py"), ("observables", "extras.py"),
                ("observables", "factory.py"), ("kernels", "deferred_checks.py"),
                ("io", "snapshot.py"), ("io", "__init__.py"), ("init", "file_init.py"),
                ("init", "__init__.py"), ("analysis", "compare.py"), ("analysis", "sedov.py"),
                ("analysis", "noh.py"), ("analysis", "gresho_chan.py"),
                ("analysis", "evrard.py"), ("analysis", "__init__.py"),
                ("telemetry", "manifest.py"), ("telemetry", "flightrec.py"),
                ("telemetry", "memory.py"), ("app", "main.py"), ("init", "plummer.py"),
                ("gravity", "ewald.py"), ("gravity", "spherical.py"),
                ("sph", "threefry.py"), ("sph", "hydro_turb.py"), ("sph", "eos.py"),
                ("init", "turbulence.py"), ("physics", "__init__.py"),
                ("physics", "cooling.py"), ("physics", "primordial.py"),
                ("init", "kelvin_helmholtz.py"), ("init", "wind_shock.py"),
                ("init", "isobaric_cube.py"), ("sph", "blockdt.py"),
                ("parallel", "mesh.py"), ("parallel", "sort.py"), ("parallel", "exchange.py"),
                ("tree", "decomposition.py"), ("kernels", "sharded_checks.py"),
                ("util", "__init__.py"), ("util", "phases.py"), ("util", "timer.py"),
                ("util", "substep_profile.py"), ("observables", "snapshot.py"),
                ("viz.py",), ("telemetry", "traceview.py"), ("kernels", "app_checks.py"),
                ("sph", "pairs.py"), ("util", "blocking.py"), ("kernels", "gather_checks.py"),
                ("kernels", "sharded_gather_checks.py"), ("tuning", "__init__.py"),
                ("tuning", "__main__.py"), ("tuning", "knobs.py"), ("tuning", "table.py"),
                ("tuning", "search.py"), ("tuning", "replay.py"), ("tuning", "cli.py"),
                ("telemetry", "cli.py"), ("telemetry", "__main__.py"),
                ("telemetry", "history.py"), ("telemetry", "serve.py"),
                ("telemetry", "tables.py"), ("kernels", "tuning_checks.py")):
        assert os.path.join("sphexa_torch", *mod) in names


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
