"""The tiny cell on the card: the program's kernels through the same
comparison, and its control. Skips without a card."""

import pytest
import torch

import azbench_tiny
from azbench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tiny_cell_on_the_card(card):
    run = azbench_tiny.run(11, dtype="bfloat16", batch=64, lanes=8)
    run.device = card
    out = harness.drive(run)
    assert out.correct, out.checks
    run = azbench_tiny.run(11, dtype="bfloat16", batch=64, lanes=8, control=True)
    run.device = card
    assert not harness.drive(run).correct
