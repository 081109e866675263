"""``salience_detr_torch/tools/cli_rehearsal.py`` at a tiny size on the CPU:
the train, test and inference CLIs run as subprocesses on the rectangles
split; the JSON fields and the pass rule, whose drawing term drops where
cv2 is missing."""

import json

import pytest

from salience_detr_torch.tools import cli_rehearsal


def test_rehearsal_runs_the_three_clis(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # each CLI's torch threads: the lane runs 6 test processes
    argv = ["--device", "cpu", "--epochs", "1", "--n-train", "8", "--n-val", "4", "--min-ap50", "0",
            "--workdir", str(tmp_path)]
    try:
        cli_rehearsal.main(argv)
        exited = False
    except SystemExit:
        exited = True
    out = json.loads([line for line in capsys.readouterr().out.splitlines() if line.startswith("{")][-1])
    assert {"train_ap50", "test_cli_ap50", "inference_preds", "inference_vis", "epochs", "platform",
            "passed"} <= set(out)
    assert out["epochs"] == 1 and out["platform"] == "cpu"
    assert out["inference_vis"] == (4 if cli_rehearsal.cv2_installed() else None)
    assert out["passed"] == cli_rehearsal.passed(out["test_cli_ap50"], out["inference_preds"],
                                                 out["inference_vis"], 4, 0.0) == (not exited)
    assert (tmp_path / "out" / "checkpoints" / "0.pth").exists()
    with open(tmp_path / "inference_preds.json") as f:
        assert len(json.load(f)) == 4


@pytest.mark.parametrize("ap50,preds,vis,want", [
    (0.5, 10, 16, True), (0.5, 10, None, True), (0.5, 10, 15, False), (0.29, 10, 16, False),
    (0.5, 0, None, False), (float("nan"), 10, None, False),
])
def test_pass_rule(ap50, preds, vis, want):
    assert cli_rehearsal.passed(ap50, preds, vis, 16, 0.30) is want


def test_cv2_blocked_counts_as_missing(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    assert cli_rehearsal.cv2_installed() is False
