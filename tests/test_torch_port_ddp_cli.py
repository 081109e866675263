"""The train CLI (python -m salience_detr_torch.train --device cpu) as 2 ranks
under the launcher's variables, on the written split and tiny config of
tests/test_torch_port_train_cli.py (a global batch of 2, one image a rank):

* 2 steps and the eval write one output directory, by rank 0 alone (its
  log, the tracker's lines, label_names.txt, the checkpoint, the snapshots
  and summary.json; no file of rank 1), and the run equals one process on
  the same split and seed: the last step's metrics at rtol 2e-5 / atol 1e-6,
  the eval's stats, and the checkpoint's weights within 1e-4 of what the
  steps moved (tests/test_torch_port_ddp_step.py's bounds);
* SIGTERM to rank 1 alone stops both ranks after the same step (a rank
  that stopped alone would leave the other blocked in the next step's
  all-reduce): both exit 0, rank 0 writes one preemption checkpoint, and a
  2-rank run resumed from it trains the step a one-process run resumed from
  a copy of it trains."""

import json
import shutil
import signal
import sys
import time

import numpy as np
import pytest
import torch

from salience_detr_torch import train
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr
from salience_detr_torch.tools import ddp_check
from salience_detr_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_port_ddp_step import TIGHT_ATOL, TIGHT_RTOL, close_to_moved
from tests.test_torch_port_train_cli import NO_TENSORBOARD, cli, split, write_config  # noqa: F401
from tests.torch_port_common import TINY_TORCH
from tests.torch_port_common import two_torch_threads  # noqa: F401

ENV = {"OMP_NUM_THREADS": "2"}


def rank_args(config, *extra):
    return ["-c", NO_TENSORBOARD + f"from salience_detr_torch.train import main; main({cli(config, *extra)!r})"]


def one_process(config, *extra):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        return train.main(cli(config, *extra))


def check_close(got, want):
    """Summary metrics and stats of a 2-rank run against one process."""
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=TIGHT_RTOL, atol=TIGHT_ATOL, err_msg=k)
    assert got["global_step"] == want["global_step"] and got["seed"] == want["seed"]
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v, rtol=0, atol=1e-6, err_msg=k)


def check_checkpoints(got_dir, want_dir, init):
    a = CheckpointManager(str(got_dir / "checkpoints")).restore()
    b = CheckpointManager(str(want_dir / "checkpoints")).restore()
    assert a["step"] == b["step"] and a["epoch"] == b["epoch"]
    for k, want in b["model"].items():
        got = a["model"][k]
        if not want.is_floating_point():
            assert torch.equal(got, want), k
            continue
        assert close_to_moved(got, want, init[k]), k


def test_two_ranks_write_one_output_dir_and_train_as_one_process(split, tmp_path):
    one_dir, ranks_dir = tmp_path / "one", tmp_path / "ranks"
    want = one_process(write_config(split, tmp_path / "one.py", one_dir), "--dry-run-steps", "2")
    ddp_check.launch(rank_args(write_config(split, tmp_path / "ranks.py", ranks_dir), "--dry-run-steps", "2"),
                     world=2, timeout=300, env=ENV)
    files = sorted(str(p.relative_to(ranks_dir)) for p in ranks_dir.rglob("*") if p.is_file())
    assert files == ["checkpoints/0.pth", "checkpoints/best_ap.pth", "checkpoints/best_ap50.pth",
                     "checkpoints/metadata.json", "label_names.txt", "log.rank0.txt", "metrics.jsonl",
                     "summary.json"]
    log = (ranks_dir / "log.rank0.txt").read_text()
    assert "data parallel: 2 ranks" in log and "Training done" in log
    got = json.loads((ranks_dir / "summary.json").read_text())
    assert got["global_step"] == 2 and got["epochs"] == [0]
    check_close(got, want)
    init, _ = build_salience_detr(SalienceDETRConfig(**TINY_TORCH), torch.device("cpu"),
                                  torch.Generator().manual_seed(0))  # the CLI's init at --seed 0
    check_checkpoints(ranks_dir, one_dir, init.state_dict())
    lines = [json.loads(x) for x in (ranks_dir / "metrics.jsonl").read_text().splitlines()]
    assert sorted(x["step"] for x in lines if "loss/loss" in x) == [0, 1]


def test_sigterm_to_one_rank_stops_both_and_the_resume_equals_one_process(split, tmp_path):
    out = tmp_path / "ranks"
    config = write_config(split, tmp_path / "train.py", out, num_epochs=50, train_transform="hflip")
    procs = ddp_check.start(rank_args(config), world=2, env=ENV)
    log = out / "log.rank0.txt"
    try:
        deadline = time.time() + 180
        while not (log.exists() and "Epoch: [0] [0]" in log.read_text()):
            if any(p.poll() is not None for p in procs) or time.time() > deadline:
                pytest.fail("training never started: " + "".join(p.communicate()[1][-2000:] for p in procs))
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        ddp_check.wait(procs, timeout=180)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    text = log.read_text()
    assert text.count("preemption checkpoint saved at epoch") == 1
    ckpts = CheckpointManager(str(out / "checkpoints"))
    state = ckpts.restore()
    assert state["step"] >= 1 and ckpts.steps() == [state["epoch"]]
    assert f"(step {state['step']}); exiting" in text

    copy = tmp_path / "one"
    shutil.copytree(out, copy)
    resumed_one = one_process(write_config(split, tmp_path / "one.py", copy, num_epochs=50,
                                           train_transform="hflip"), "--dry-run-steps", "1")
    ddp_check.launch(rank_args(config, "--dry-run-steps", "1"), world=2, timeout=300, env=ENV)
    got = json.loads((out / "summary.json").read_text())
    assert got["global_step"] == resumed_one["global_step"] == state["step"] + 1
    check_close(got, resumed_one)
    check_checkpoints(out, copy, state["model"])
