"""The control: the plain reference put in the program's place with one
guarantee of the configuration broken (its `control`: cpu fit for the
basic configuration, the spread constraints for the spreading one) comes
out as not correct, on three seeds of each cell's cut."""

import pytest

from portbench import check, control

from pbhelpers import SMALL, SMALL_BACKLOG, small_cell


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("seed", [1, 2, 3_000_000_019])
def test_control_is_not_correct(name, seed):
    numbers = control.readings(small_cell(name), seed, 0.5)
    assert not numbers["correct"], numbers
    assert numbers["placement_mismatch"] > check.LIMITS["placement_mismatch"]


def test_control_breaks_the_stated_guarantee_only():
    """The broken switch, the configuration's `control`, names a
    guarantee the configuration states."""
    for name in SMALL:
        cell = small_cell(name)
        broken = cell.config["control"]
        stated = " ".join(cell.config["guarantees"])
        assert {"cpu_fit": "fits its node", "spread": "maxSkew"}[broken] \
            in stated
    assert SMALL_BACKLOG > 0
