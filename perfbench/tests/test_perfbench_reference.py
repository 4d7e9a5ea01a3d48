"""The reference agrees with the program on the CPU at small sizes: each
cell's whole run (its driver, the program's timed path on the CPU, the
comparison) reads well inside the cell's limits; and the control (the
reference one precision lower in the program's place) reads outside
them."""
import pytest
import torch

from perfbench.common import checks_from, load_module
from perfbench.tests.tiny_cells import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11          # larger than 32 signed bits hold
# CPU against the reference: the same float32 operations in another
# order, so far below any cell's limit
TIGHT = 1e-4

CELLS = ["md-w4a8-r128", "md-fp32-r128", "qat-w4a8-b32",
         "serve-w4a8-poisson"]


def _run(name, **kw):
    cell = tiny(name)
    out = load_module("drivers", cell.traffic["driver"]).run(
        cell, SEED, 0.3, False, CPU, **kw)
    return cell, out


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(name):
    cell, out = _run(name)
    checks = checks_from(out.readings, cell.limits)
    assert all(c.ok for c in checks), checks
    for key, value in out.readings.items():
        assert value <= TIGHT, (key, value)


@pytest.mark.parametrize("name", [n for n in CELLS if "fp32" not in n])
def test_control_fails(name):
    cell, out = _run(name, control=True)
    checks = checks_from(out.readings, cell.limits)
    assert not all(c.ok for c in checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in CELLS if "fp32" in n])
def test_tf32_control_fails_on_the_card(name, card):
    cell = tiny(name)
    out = load_module("drivers", cell.traffic["driver"]).run(
        cell, SEED, 0.3, False, card, control=True)
    checks = checks_from(out.readings, cell.limits)
    assert not all(c.ok for c in checks), checks
