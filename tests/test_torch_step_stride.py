"""Port BatchStep vs the reference's with --stride 2 (every second window of
the fused keys), single-end and paired, canonical off and on: keep masks,
tallies, stats and table planes, exact. Helpers in test_torch_step.py."""
import pytest

from test_torch_step import check_step_matches_reference


@pytest.mark.parametrize("paired,canonical", [(False, False), (True, True)])
def test_stride_step_matches_reference(paired, canonical):
    check_step_matches_reference(paired, canonical, 2)
