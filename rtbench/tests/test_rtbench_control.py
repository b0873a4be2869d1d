"""``correct`` comes out false for the control (the reference in bfloat16
in the program's place) and for each fault of the timed path, driving
the rest of a run on the CPU at a small frame."""

import pytest

from conftest import small_cell
from rtbench import run

CELLS = ("scene1.fly", "scene2.fly", "scene1.fit", "scene2.fit")
CASES = [(w, f) for w in CELLS
         for f in run.load_kind(small_cell(w, 1).mix["kind"]).FAULTS]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    from rtbench import control
    cell = small_cell(workload, 31)
    nums = run.load_kind(cell.mix["kind"]).control(cell, "cpu",
                                                   control.LOWER)
    assert any(v > cell.limits[k] for k, v in nums.items()), nums


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault):
    cell = small_cell(workload, 2 ** 31 + 1)
    out = run.run_cell(cell, 0.3, False, "cpu", fault=fault)
    line = run.result_line(cell, out, False, "cpu")
    assert not line["correct"], line["checks"]
    assert line["failed"] > 0


@pytest.mark.card
def test_one_short_run_on_the_card(card):
    cell = run.load_cell("scene1.fly", 2 ** 31 + 2)
    out = run.run_cell(cell, 1.0, True, card)
    line = run.result_line(cell, out, True, card)
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
