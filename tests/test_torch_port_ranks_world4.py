"""``repeat_check ranks`` at four ranks of one image each, on the CPU (ROADMAP
C-32): the tiny model's step 0 as 4 gloo ranks against one process, with
every module output of the forward and every discrete selection of the
transformer recorded, in both numerics.

On the card the first output to part at one image a rank is the salience
predictor's first Linear after its norm (a GEMM whose rows cuBLAS sums in
another order at a quarter of the rows), and the salience top-k then flips
on a near-tie; on this CPU oneDNN's convolutions part first (their
algorithm follows the batch too), by a few float32 ulps, and the tiny
model's selections do not flip.  The test holds what the tool reports: the
selections recorded alike in both runs, none parting, and a step-0 gap far
below the card's bound."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.torch_port_common import TINY_TORCH

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("deterministic", [False, True], ids=["default", "deterministic"])
def test_ranks_at_one_image_each_report_modules_and_selections(tmp_path, deterministic):
    cfg = tmp_path / "tiny.py"
    cfg.write_text("from salience_detr_torch.models.factory import SalienceDETRConfig\n"
                   f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n")
    proc = subprocess.run(
        [sys.executable, "-m", "salience_detr_torch.tools.repeat_check", "ranks", "--world", "4", "--dtype", "f32",
         "--device", "cpu", "--model-config", str(cfg), "--canvas", "96", "128", "--out", str(tmp_path / "out")]
        + (["--deterministic"] if deterministic else []),
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith("repeat_check ranks: 4 gloo ranks against one process, f32")
    assert "first selection that differs: none" in line
    gap = float(re.search(r"largest metric gap (\S+) ", line).group(1))
    assert gap < 1e-4
    ranks, one = (torch.load(tmp_path / "out" / f, weights_only=False) for f in ("ranks.pt", "one.pt"))
    names = [s["name"] for s in one["selections"]]
    assert names == [s["name"] for s in ranks["selections"]]
    assert sum(n.startswith("stable_topk (salience_transformer.py:") for n in names) >= 6  # 4 levels, sort, proposals
    assert names[-1].startswith("grid_nms_topk") and all(s["indices"].shape[0] == 1 for s in one["selections"])
