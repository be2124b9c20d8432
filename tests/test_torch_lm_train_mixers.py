"""One ``train_step`` of qwen3-moe-30b-a3b, jamba-v0.1-52b and xlstm-1.3b
against the JAX package's: the bounds and the method of
``test_torch_lm_train_archs.py``, which runs the other archs."""

import pytest
from test_torch_lm_train_archs import MIXER_ARCHS, assert_one_step_matches_reference


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_one_train_step_matches_reference(arch):
    assert_one_step_matches_reference(arch)
