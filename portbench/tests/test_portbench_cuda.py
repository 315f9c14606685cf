"""On the card: the control (the plain reference in TF32 in the port's
place) comes out not correct, and the port correct, at small widths.
Run on the chip with ``python3 -m pytest portbench/tests/
test_portbench_cuda.py -q``."""
import pytest
import torch

from portbench import harness
from portbench.tests import helpers

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the chip)")
    return torch.device("cuda")


@pytest.fixture()
def root(tmp_path):
    return helpers.copy_benchmark(str(tmp_path))


@pytest.mark.parametrize("cell", [helpers.tiny_train_cell,
                                  helpers.tiny_drawing_cell])
@pytest.mark.parametrize("control", [False, True])
def test_control_fails_and_the_port_passes(card, root, cell, control):
    name = cell(root)
    r = harness.run_cell(harness.load_cell(name, root), helpers.SEED, 1.0,
                         False, device=card, control=control,
                         say=lambda *a, **k: None)
    assert r["correct"] is (not control), r["checks"]
