"""Port parity: the Fig. 6 cells (channel equalisation at 12–32 dB × the
three accelerators) against the JAX package at cut lengths — the cases and
tolerances of tests/test_torch_configs.py, which holds the helpers; this
file lets the test workers split the work."""

import pytest

from test_torch_configs import FIG6_CELLS, assert_cell_matches_reference
from test_torch_fig5 import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("cell", FIG6_CELLS)
def test_fig6_cell_matches_reference(cell):
    assert_cell_matches_reference(cell)
