"""Port BatchStep vs the reference's on paired reads (keep masks, tallies,
stats and table planes; exact), and step_many against a loop of step. The
helpers live in test_torch_step.py; each file holds few reference compiles
so it stays well inside the test time limit."""
import pytest

from test_torch_step import (
    check_step_many_equals_steps, check_step_matches_reference,
)


@pytest.mark.parametrize("canonical", [False, True])
def test_paired_step_matches_reference(canonical):
    check_step_matches_reference(True, canonical, 1)


def test_step_many_equals_steps():
    check_step_many_equals_steps()
