"""The output check fails what it has to fail, through the whole harness
past its look for a card: the program's own bfloat16 path (the control)
and planted faults in the timed path, at a tiny size on the CPU and against
the limits the cells state."""

from __future__ import annotations

import pytest

FAULTS = [
    ("flagship.train", "bf16"),
    ("flagship.train", "unchanged"),      # a step that leaves its state as it was
    ("flagship.train", "half_batch"),     # half of the views left out of the loss
    ("nerv_gear.relight_hard", "bf16"),
    ("nerv_gear.relight_hard", "altered"),  # every image 5% off where it is made
    ("nerv_gear.relight_hard", "half_batch"),  # half of each image left black
    ("flagship.view", "bf16"),
    ("flagship.view", "altered"),
    ("nerv_gear.relight_learned", "bf16"),
]


@pytest.mark.parametrize("cell,variant", FAULTS)
def test_fault_is_not_correct(run_tiny, cell, variant):
    result = run_tiny(cell, variant=variant)
    assert not result["correct"], result["checks"]
