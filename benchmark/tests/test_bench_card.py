"""The harness on the card at a size between the tests' and the cells':
a whole run of each workload must come out correct, its kernels
built and its device named. Run on the chip with
``python -m pytest benchmark/tests -q -m gpu``."""

import time

import pytest
import torch

from benchmark import harness

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("workload,side", [("sedov-std-100.lists", 40),
                                           ("evrard-ve-125.grav", 40)])
def test_a_run_on_the_card_is_correct(workload, side):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU mode here)")
    ov = {"config": {"side": side}, "traffic": {"warmup_steps": 3, "trace_steps": 3}}
    res = harness.run(workload, 2**31 + 9, 3.0, True, "cuda", time.perf_counter(),
                      overrides=ov, log=lambda s: None)
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
