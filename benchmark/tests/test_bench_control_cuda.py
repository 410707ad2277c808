"""On the card, at each cell's own size: the control (the plain reference
in the program's place, computed in the precision below the
configuration's) and, for a training cell, the half-batch fault planted
in it, come out not correct under the cell's limits, while the program's
own run of the same seed holds them.

    python -m pytest benchmark/tests/test_bench_control_cuda.py -m cuda
"""

import pytest
import torch

from benchmark import harness
from benchmark.reference.compare import held
from benchmark.run import run_cell

CELLS = [w["name"] for w in
         harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.cell(name)
    res = run_cell(cell, 2 ** 31 + 97, 2.0, False, torch.device("cuda", 0),
                   0.0, control=True)
    assert held(res["readings"], cell["limits"]), res["readings"]
    assert not held(res["control_readings"], cell["limits"]), \
        res["control_readings"]
    for fault in res.get("fault_readings", {}).values():
        assert not held(fault, cell["limits"]), fault
