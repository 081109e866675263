"""The control (the reference with float8 operands in the program's place)
comes out not correct against each cell's limits, at a tiny size; the
program there is correct.  The readings at the cells' own sizes are
``control.py``'s, on the card."""

import sys

import pytest
import torch

from portbench.harness import check
from portbench.harness.common import BENCH
from portbench.tests.tiny import tiny_cell

sys.path.insert(0, str(BENCH))
import control  # noqa: E402


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_control_fails(kind):
    torch.manual_seed(0)
    cell, cfg = tiny_cell(kind)
    seeds = [2**31 + 3, 2**31 + 4, 2**31 + 5]
    if kind == "serve":
        rows = control.serve_readings(cell, cfg, [seeds[0]], seeds, torch.device("cpu"))
    else:
        rows = control.train_readings(cell, cfg, [seeds[0]], seeds, [], torch.device("cpu"))
    for row in rows:
        numbers = {k: v for k, v in row.items() if k not in ("kind", "seed")}
        assert check.passed(check.judged(numbers, cell["limits"])) == (row["kind"] == "program"), row
