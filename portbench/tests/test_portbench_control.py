"""The control (the reference in the program's place, one precision
lower) comes out as not correct: on the CPU at a tiny size, and on a card
at the cell's own batch."""

import pytest
import torch

from portbench import check, control, spec
from portbench.tests.conftest import TINY


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails_on_the_cpu(bench, name):
    out = control.control_numbers(spec.cell(bench, name), 2 ** 33 + 11,
                                  "cpu", TINY[name])
    assert out["fails"]
    assert any(v > check.LIMITS[k] for k, v in out["numbers"].items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TINY))
def test_control_fails_on_the_card(bench, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # a few chunks of the cell's batch: the four ranks of the mesh cell
    # share the card over gloo, each with one chunk in flight
    small = {".deep": {"traffic": {"max_words": 4 * 16384}},
             ".deep16m": {"traffic": {"max_words": 262144}}}.get(
        name[name.rindex("."):], {})
    out = control.control_numbers(spec.cell(bench, name), 2 ** 33 + 12,
                                  "cuda", small)
    assert out["fails"]
