"""A run drives the program with a fault planted under its timed path and
sees ``correct`` come out false, for each fault the cells can have, also
where the fault starts only once set-up's warm-up is over (a path that
switches once warmed up); the controls run through the same check. The
harness's look for a card is skipped: the run is on the CPU, at the
families' test sizes, held to the real cells' limits."""

import time

import pytest

from portbench import faults
from portbench.core import bench, spec
from portbench.drivers import attack, train
from portbench.tests import tiny

CELLS = {"attack": ["vit_tiny.pgd3_b4", "swin_tiny.pgd3_b4"],
         "train": ["vit_tiny.lora_b4", "vit_tiny.full_b4"]}
# the calls set-up makes before the window; the LoRA cell's limits file
# (its cell is not in the benchmark) has no limits for the window's last steps
WARM = {"attack": attack.WARMUP_UNITS, "train": train.CHECKED_STEPS}
AFTER_WARM = ["vit_tiny.pgd3_b4", "swin_tiny.pgd3_b4", "vit_tiny.full_b4"]


@pytest.mark.parametrize("kind, cell, fault, warm", [
    (kind, cell, fault, warm) for kind, cells in CELLS.items() for cell in cells
    for fault in faults.NAMES for warm in (False, True) if not warm or cell in AFTER_WARM])
def test_a_planted_fault_is_not_correct(kind, cell, fault, warm, tiny_root):
    undo = faults.plant(kind, fault, after=WARM[kind] if warm else 0)
    try:
        line = bench.run(spec.cell(cell, tiny_root), 2 ** 31 + 29, 0.05, False, "cpu",
                         time.perf_counter())
    finally:
        undo()
    assert not line["correct"], line["checks"]
    assert line["failed"] > 0
    if warm and kind == "train":  # set-up's steps were sound: the window's last ones fail
        assert all(c["value"] <= c["limit"] for n, c in line["checks"].items()
                   if "." not in n), line["checks"]


def test_the_sound_program_is_correct_again_after_the_faults(tiny_root):
    for cells in CELLS.values():
        for cell in cells:
            line = bench.run(spec.cell(cell, tiny_root), 2 ** 31 + 29, 0.05, False, "cpu",
                             time.perf_counter())
            assert line["correct"], (cell, line["checks"])


@pytest.mark.parametrize("cell", CELLS["attack"])
def test_the_w8a8_control_runs_through_the_check(cell, tiny_root):
    line = bench.run(spec.cell(cell, tiny_root), 2 ** 31 + 31, 0.05, False, "cpu",
                     time.perf_counter(), control=True)
    sound = bench.run(spec.cell(cell, tiny_root), 2 ** 31 + 31, 0.05, False, "cpu",
                      time.perf_counter())
    assert line["_info"]["values"]["ascent_lost"] > 10 * sound["_info"]["values"]["ascent_lost"]


@pytest.mark.parametrize("cell", CELLS["train"])
def test_the_float8_control_is_not_correct(cell, tiny_root):
    """The float8 reference in the program's place, from the program's own
    starts; the same run reads the program's numbers too."""
    line = bench.run(spec.cell(cell, tiny_root), 2 ** 31 + 37, 0.05, False, "cpu",
                     time.perf_counter(), control=True)
    assert not line["correct"], line["checks"]
    prog = line["_info"]["program_values"]
    assert set(prog) == set(line["_info"]["values"])
    assert all(v < 1e-4 for v in prog.values()), prog


@pytest.mark.parametrize("cell", ["vit_tiny.pgd3_b4", "vit_tiny.full_b4"])
def test_the_check_reads_the_windows_last_units(cell, tiny_root, monkeypatch):
    c = spec.cell(cell, tiny_root)
    seen = {}
    closing = c.driver.Driver.closing

    def spy(self):
        seen["driver"], seen["k"] = self, self.k
        return closing(self)

    monkeypatch.setattr(c.driver.Driver, "closing", spy)
    line = bench.run(c, 2 ** 31 + 41, 0.2, False, "cpu", time.perf_counter())
    drv, k = seen["driver"], seen["k"]
    assert line["correct"] and k > 2
    if c.traffic["driver"] == "attack":
        ks = sorted(out[0] for out in drv.outputs.values())
        assert len(ks) == attack.CHECKED and all(k <= j < k + attack.CLOSING for j in ks)
    else:
        assert drv.runs["last"]["k0"] == k and drv.runs["start"]["k0"] == 0
