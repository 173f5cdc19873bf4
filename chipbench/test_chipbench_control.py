"""The control: the plain reference put in the program's place, every
product's operands rounded to float8 e4m3 (the step below the
configurations' bfloat16).  On the CPU at a small size it has to read
worse than the program by three times or more on some compared number;
on the card (`cuda`), at a cell's own size, it has to come out not
correct under the cell's limits.  `chipbench/calibrate.py` reads the
program's and the control's numbers over many seeds on the card."""
import pytest
import torch

from calibrate import serve_readings, train_readings
from harness import spec
from harness.small import small_cell

SERVING = ("dsmoe-prefill-2k", "rwkv6-prefill-4k")
TRAINING = ("dsmoe-train-4k", "rwkv6-train-4k")
COMPARED = ("grad_error", "change_gap")


def serving_readings(cell, seed, device):
    return serve_readings(cell, seed, 0.5, True, device)


def training_readings(cell, seed, device):
    """(the program's compared numbers, the control's), each against the
    float32 reference."""
    r = train_readings(cell, seed, True, False, device)
    return ({n: r["program"][n] for n in COMPARED},
            {n: r["control"][n] for n in COMPARED})


@pytest.mark.parametrize("seed", (1, 2, 3))
@pytest.mark.parametrize("name", SERVING)
def test_serving_control_reads_worse_at_a_small_size(name, seed):
    r = serving_readings(small_cell(name), seed, "cpu")
    assert r["control_gap_mean"] > 0
    assert r["control_gap_mean"] >= 3 * r["served_gap_mean"]


@pytest.mark.parametrize("seed", (1, 2, 3))
@pytest.mark.parametrize("name", TRAINING)
def test_training_control_reads_worse_at_a_small_size(name, seed):
    program, control = training_readings(small_cell(name), seed, "cpu")
    assert max(control[n] / max(program[n], 1e-12) for n in program) >= 3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVING)
def test_serving_control_fails_at_the_cells_size(name):
    device = _card()
    cell = spec.cell(name)
    r = serving_readings(cell, 2 ** 31 + 3, device)
    control = {n: r[n.replace("served", "control")] for n in cell.limits}
    assert any(v > cell.limits[n]["limit"] for n, v in control.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAINING)
def test_training_control_fails_at_the_cells_size(name):
    device = _card()
    cell = spec.cell(name)
    _, control = training_readings(cell, 2 ** 31 + 3, device)
    assert any(control[n] > cell.limits[n]["limit"] for n in cell.limits)
