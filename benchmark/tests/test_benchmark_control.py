"""The control comes out not correct at a cell's own size on the card:
the reference one precision below the configuration's (fp8 under
bfloat16, TF32 under float32) in the program's place, held to the
reference by the cell's limits.  Needs a card; skips without one."""

import pytest

from benchmark import calibrate
from benchmark.tests import tiny


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's precisions run there")


def _fails(numbers, limits):
    return any(numbers[k] > float(v) for k, v in limits.items()
               if k in numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["music.train", "sop.train"])
def test_the_training_control_is_not_correct(name):
    _card()
    cell = tiny.full(name)
    row = calibrate.train_seed(cell, 2 ** 32 + 17, control=True)
    assert not _fails(row["program"], cell.limits)
    assert _fails(row["control"], cell.limits)
    assert _fails(row["half_batch"], cell.limits)


@pytest.mark.cuda
def test_the_serving_control_is_not_correct():
    _card()
    cell = tiny.full("music.serve")
    row = calibrate.serve_seed(cell, 2 ** 32 + 19)
    assert not _fails(row["program"], cell.limits)
    assert _fails(row["control"], cell.limits)
