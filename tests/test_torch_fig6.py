"""The Fig. 6 cells at 12–20 dB (channel equalisation × the three
accelerators; 24–32 dB in tests/test_torch_fig6_high.py): the JAX
package's numbers chip_smoke.py holds the card to, recomputed here to 1e-9
(see tests/test_torch_fig5.py, which holds the helpers; the files let the
test workers split the work)."""

import pytest

from test_torch_fig5 import ACCELERATORS, assert_cell_constants, one_torch_thread  # noqa: F401

FIG6_CELLS = [f"channel_eq@{snr}dB/{acc}" for snr in (12, 16, 20) for acc in ACCELERATORS]


@pytest.mark.parametrize("cell", FIG6_CELLS)
def test_chip_smoke_fig6_constants_come_from_the_reference(cell):
    assert_cell_constants(cell)
