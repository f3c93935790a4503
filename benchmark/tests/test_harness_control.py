"""The control on the card: the reference one precision step below the
configuration's (int4 weights and an fp8 vocoder for the int8 plane,
TF32 for the f32 plane) put in the program's place fails the cell's limits, on three
seeds, at the cell's own size, while the program on the same requests
passes them. Needs a CUDA card; run it on the chip with

    python -m pytest benchmark/tests/test_harness_control.py -m cuda
"""

import time

import pytest

from benchmark import check, harness

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SEEDS = (41, 42, 43)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    import benchmark.run as R

    R._env()
    spec = harness.load_spec()
    c = harness.cell(spec, cell)
    limits = harness.mix_of(c)["check"]["limits"]
    for seed in SEEDS:
        out = R.run_cell(spec, c, seed, 8.0, False,
                         torch.device("cuda", 0), time.monotonic(),
                         control=True)
        assert out["correct"], out["check"]
        assert not check.verdict(out["control"], limits), out["control"]
