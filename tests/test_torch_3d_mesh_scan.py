"""The dry run's scan charging against the full loop on the 2 x 2 x 2
fake mesh under tp, prefill_32k and train_4k
(``tests/test_torch_scan.py`` has the method, the other cells and why
these two sit in a file of their own: each spends ~100-160 s here in
torch 2.13's graph-based redistribute planner on its first run in a
process)."""
import pytest

from test_torch_scan import assert_charging_is_exact


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_charging_equals_the_full_loop_on_the_3d_mesh_under_tp(shape):
    assert_charging_is_exact((2, 2, 2), shape, "tp")
