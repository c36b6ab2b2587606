"""The harness on the CPU at small sizes: a rehearsal of a whole run, the
guard against JAX, the refusal without a card, the faults that must come
out not correct, the trace reduction, and a cell added by new files
alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.helpers import SMALL, run_small

ROOT = harness.ROOT


def _run_py(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600, env=env)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_rehearsal_is_correct_and_reports_its_metrics(workload):
    res = run_small(workload, seed=2**31 + 77)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert {"updates_per_s", "sim_time_per_s", "setup_s"} <= set(res["metrics"])
    assert all(v[0] <= v[1] for v in res["checks"].values())


def test_rehearsal_loads_no_jax_in_its_process():
    code = ("import sys, time; sys.path.insert(0, %r); "
            "from benchmark.tests.helpers import run_small; from benchmark import harness; "
            "r = run_small('sedov-std-100.lists', 5, seconds=1.0); "
            "print(r['correct'], harness.forbidden_modules(), "
            "sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'sphexa_tpu'}))" % ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split() == ["True", "[]", "[]"]


@pytest.mark.parametrize("loads_jax", [False, True])
def test_run_py_prints_no_result_once_jax_is_loaded(tmp_path, loads_jax):
    """run.py driven past its look for a card at a small CPU size, in a
    copy of the benchmark that has one more metric reader; where that
    reader imports a (stub) ``jax``, after the window and the reference,
    the run ends non-zero and prints no result."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".work", ".cache", "__pycache__"))
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    body = "import jax  # noqa: F401\n" if loads_jax else ""
    (tmp_path / "benchmark" / "metrics" / "late_reader.py").write_text(
        body + "def read(ctx):\n    return 1.0\n")
    spec = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    spec["end_to_end"].append({"name": "late_reader", "unit": "1", "better": "higher",
                               "bound": 0.25, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, torch; sys.path[:0] = [%r, %r]; sys.path.append(%r)\n"
        "from benchmark import run, harness\n"
        "orig = harness.run\n"
        "def small(w, seed, seconds, trace, device, t0, **k):\n"
        "    ov = {'config': {'side': 12}, 'traffic': {'warmup_steps': 2}}\n"
        "    return orig(w, seed, seconds, trace, 'cpu', t0, overrides=ov, **k)\n"
        "harness.run = small\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 1\n"
        "sys.exit(run.main(['--workload', 'sedov-std-100.lists', '--seed', '5', "
        "'--seconds', '1', '--trace', '0']))\n"
        % (str(tmp_path), str(tmp_path / "stub"), ROOT))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    if loads_jax:
        assert p.returncode != 0 and p.stdout.strip() == "", p.stdout[-2000:]
        assert "forbidden modules loaded: ['jax']" in p.stderr
    else:
        assert p.returncode == 0, p.stderr[-2000:]
        res = json.loads(p.stdout.strip().splitlines()[-1])
        assert res["correct"] is True and res["metrics"]["late_reader"]["value"] == 1.0


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sphexa_tpu_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _run_py(["--workload", "sedov-std-100.lists", "--seed", "1", "--seconds", "1",
                 "--trace", "0"])
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_in_a_checkout_without_the_port_fails(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".work", ".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run_py(["--workload", "sedov-std-100.lists", "--seed", "1", "--seconds", "1",
                 "--trace", "0"], cwd=tmp_path, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _patch_forces(monkeypatch, alter):
    """Break the momentum-energy op of both propagators underneath the
    step: ``alter(ax, ay, az, du)`` edits its outputs in place."""
    from sphexa_torch import propagator

    for name in ("pallas_momentum_energy_std", "pallas_momentum_energy_ve"):
        orig = getattr(propagator.pe, name)

        def wrapped(*a, _orig=orig, **k):
            ax, ay, az, du, dt, extra = _orig(*a, **k)
            ax, ay, az, du = ax.clone(), ay.clone(), az.clone(), du.clone()
            alter(ax, ay, az, du)
            return ax, ay, az, du, dt, extra

        monkeypatch.setattr(propagator.pe, name, wrapped)


def _unchanged(sim):
    """A step that returns its state unchanged."""
    orig = sim.step

    def step():
        s, b = sim.state, sim.box
        d = orig()
        sim.state, sim.box = s, b
        return d

    sim.step = step


@pytest.mark.parametrize("workload", sorted(SMALL))
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_in_the_timed_path_is_not_correct(workload, fault, monkeypatch):
    hook = None
    if fault == "unchanged":
        hook = _unchanged
    else:
        def half(ax, ay, az, du):
            # half of the particles left out of the forces
            n = ax.shape[0]
            for a in (ax, ay, az, du):
                a[n // 2:] = 0.0

        def altered(ax, ay, az, du):
            # one particle's answer altered where it is produced
            k = int(torch.argmax(torch.abs(ax)))
            ax[k] *= 1.01
            du[int(torch.argmax(torch.abs(du)))] *= 1.01

        def hook(sim, alter={"half": half, "altered": altered}[fault]):
            _patch_forces(monkeypatch, alter)

    res = run_small(workload, seed=2**31 + 5, fault=hook)
    assert res["correct"] is False
    assert any(v[0] > v[1] for v in res["checks"].values())


def test_trace_summary_attributes_device_time_to_phases_and_steps(tmp_path):
    from benchmark import trace

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench/step", "ts": 0, "dur": 100,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "sphexa/density", "ts": 10, "dur": 20,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 2,
         "pid": 1, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 40, "dur": 30, "pid": 0, "tid": 7,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "user_annotation", "name": "bench/step", "ts": 100, "dur": 100,
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 2,
         "pid": 1, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 150, "dur": 10, "pid": 0, "tid": 7,
         "args": {"correlation": 8}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace.summarize(str(path))
    assert s["phase_us"] == {"density": 30.0}
    assert s["step_us"] == [30.0, 10.0]
    assert s["busy_us"] == 40.0 and s["window_us"] == 200.0 and s["device_events"] == 2
    assert s["coverage"] == 0.75
    assert dict(s["idle_gaps"])["bench/step"] == 160.0


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A throwaway traffic mix, configuration, limits and metric added as
    new files in a copy of the benchmark, plus a BENCHMARK.json entry,
    run with no existing file edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns(".work", ".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "traffic" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "check_every": 2, "use_lists": True, "warmup_steps": 2,
         "trace_steps": 2}))
    cfg = json.loads((bench / "configs" / "sedov-std-100.json").read_text())
    cfg.update(name="sedov-std-10", side=10, particles=1000)
    (bench / "configs" / "sedov-std-10.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "limits" / "sedov-std-100.json", bench / "limits" / "sedov-std-10.json")
    (bench / "metrics" / "steps_done.py").write_text(
        "def read(ctx):\n    return float(ctx['counters']['steps'])\n")
    spec = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    spec["configs"].append({"name": "sedov-std-10", "source": "test",
                            "file": "benchmark/configs/sedov-std-10.json", "reduced": ["side"],
                            "why": "test"})
    spec["workloads"].append({"name": "sedov-std-10.tiny", "config": "sedov-std-10",
                              "traffic": "tiny", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                               "bound": 0.25, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, json, time; sys.path.insert(0, %r); sys.path.append(%r); "
            "from benchmark import harness; "
            "r = harness.run('sedov-std-10.tiny', 3, 1.0, False, 'cpu', time.perf_counter(), "
            "log=lambda s: None); print(json.dumps(r))" % (str(tmp_path), ROOT))
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["metrics"]["steps_done"]["value"] >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before
