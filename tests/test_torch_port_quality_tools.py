"""The port's training-quality tools (``salience_detr_torch/tools/
overfit_check.py``, ``validate_static_shapes.py``, ``quality_campaign.py``
and their helpers) at tiny sizes on the CPU: their JSON fields and pass
rules, the JAX tools' sampling flags in the port's terms, and every tool
module importing, generating its data and training with cv2, JAX and the
JAX package blocked from import."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from salience_detr_torch.tools import overfit_check, quality, quality_campaign, validate_static_shapes
from tests.torch_port_common import two_torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ("synthetic", "quality", "overfit_check", "validate_static_shapes", "cli_rehearsal",
         "finetune_rehearsal", "quality_campaign")


def last_json(out: str) -> dict:
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def test_tools_import_and_run_without_cv2_or_jax(tmp_path):
    script = f"""
import sys
import torch
torch.set_num_threads(2)
for name in ("cv2", "jax", "salience_detr_tpu", "tools"):
    sys.modules[name] = None  # any import of them fails
import importlib
for tool in {TOOLS!r}:
    importlib.import_module("salience_detr_torch.tools." + tool)
from salience_detr_torch.tools import synthetic, overfit_check
synthetic.make_dataset({str(tmp_path / "r")!r}, 2, 0)
synthetic.make_rich_dataset({str(tmp_path / "q")!r}, 1, 0, (64, 96))
synthetic.make_defect_dataset({str(tmp_path / "d")!r}, 1, 0)
try:
    overfit_check.main(["--device", "cpu", "--steps", "1", "--size", "32"])
except SystemExit:
    pass
loaded = [m for m in ("cv2", "jax", "salience_detr_tpu", "tools") if sys.modules.get(m) is not None]
assert not loaded and not any(m.startswith(("jax.", "salience_detr_tpu.", "tools.")) for m in sys.modules), loaded
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_tools_refuse_a_missing_card():
    if quality.torch.cuda.is_available():
        pytest.skip("a card is present")
    for main, argv in ((overfit_check.main, []), (validate_static_shapes.main, []),
                       (quality_campaign.main, ["--variant", "hybrid", "--seed", "0"])):
        with pytest.raises(SystemExit, match="cuda"):
            main(argv)


@pytest.mark.parametrize("exact,groups,decoder,want,name", [
    (False, 0, -1, (1, 1), "shared"),            # the JAX tool's default: shared everywhere
    (True, 0, -1, (None, None), "exact"),         # per head everywhere
    (False, 0, 0, (1, None), "shared_dec0"),      # the flagship's hybrid
    (False, 2, -1, (2, 2), "groups2"),
    (True, 4, 0, (4, None), "groups4_dec0"),
    (False, 0, 2, (1, 2), "shared_dec2"),
])
def test_sampling_flags_in_the_ports_terms(exact, groups, decoder, want, name):
    assert quality.sampling_groups(exact, groups, decoder) == want
    assert quality.sampling_name(exact, groups, decoder) == name


def test_overfit_check_json_and_rule(capsys):
    try:
        result = overfit_check.main(["--device", "cpu", "--steps", "3", "--size", "48"])
        failed = False
    except SystemExit as e:
        assert "did not drop" in str(e)
        failed = True
    out = last_json(capsys.readouterr().out)
    assert set(out) >= {"first_loss", "last_loss", "ratio", "steps", "passed", "platform", "launches_per_step"}
    assert out["passed"] == (out["last_loss"] < 0.5 * out["first_loss"]) == (not failed)
    assert out["platform"] == "cpu" and out["steps"] == 3
    assert all(v == 0 for v in out["launches_per_step"].values())  # the CPU runs the plain versions
    if not failed:
        assert result == out


def test_overfit_check_can_run_deterministically():
    import torch

    was = torch.are_deterministic_algorithms_enabled()
    try:
        try:
            overfit_check.main(["--device", "cpu", "--steps", "1", "--size", "32", "--use-deterministic-algorithms"])
        except SystemExit:  # one step cannot halve the loss
            pass
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        torch.use_deterministic_algorithms(was)


def test_overfit_batch_is_the_jax_tools():
    """The batch the JAX tool draws from default_rng(0): images, centres and
    sizes, labels, in that order."""
    import numpy as np

    batch = overfit_check.one_batch(32, "cpu")
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.25, 0.75, (2, 6, 2)), rng.uniform(0.1, 0.25, (2, 6, 2))], -1)
    labels = rng.integers(0, 7, (2, 6))
    np.testing.assert_array_equal(batch["images"].permute(0, 2, 3, 1).numpy(), images)
    np.testing.assert_array_equal(batch["targets"].boxes.numpy(), boxes.astype(np.float32))
    np.testing.assert_array_equal(batch["targets"].labels.numpy(), labels)


class EpochLoader:
    """Three packed batches an epoch, their image ids (epoch, index)."""

    def __init__(self):
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __iter__(self):
        import numpy as np

        for i in range(3):
            yield {"images": np.zeros((1, 4, 4, 3), np.uint8), "image_sizes": np.array([[4, 4]]),
                   "labels": np.zeros((1, 1), np.int32), "boxes": np.full((1, 1, 4), 0.5, np.float32),
                   "gt_valid": np.ones((1, 1), bool), "image_ids": [(self.epochs[-1], i)]}


@pytest.mark.parametrize("bad_step", [None, 4])
def test_train_steps_caps_the_epochs_loop(capsys, bad_step):
    """``train_steps`` through the train CLI's epoch loop: the step cap ends
    the third epoch early, the loss is fetched every ``log_every`` steps and
    at the last, ``after_step`` sees every count, and a non-finite loss at a
    fetch raises."""
    import torch

    loader, seen, after = EpochLoader(), [], []

    def step(batch, generator):
        seen.append(batch["image_ids"][0])
        loss = float("nan") if len(seen) - 1 == bad_step else float(len(seen))
        return {"loss": torch.tensor(loss)}

    args = (step, loader, torch.device("cpu"), torch.Generator(), 7)
    if bad_step is not None:
        with pytest.raises(FloatingPointError, match=f"at step {bad_step}"):
            quality.train_steps(*args, log_every=2)
        assert len(seen) == bad_step + 1
        return
    losses = quality.train_steps(*args, log_every=3, label="[t] ", after_step=after.append)
    assert losses == [(0, 1.0), (3, 4.0), (6, 7.0)]
    assert loader.epochs == [0, 1, 2] and after == list(range(1, 8))
    assert seen == [(e, i) for e in range(3) for i in range(3)][:7]
    assert "[t] step     6: loss 7.0000" in capsys.readouterr().out


@pytest.mark.parametrize("min_ap50", [0.0, 1.01])
def test_validate_static_shapes_json_and_rule(tmp_path, capsys, min_ap50):
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--n-images", "6", "--min-ap50", str(min_ap50),
            "--decoder-sampling-groups", "0", "--workdir", str(tmp_path)]
    if min_ap50 > 1:
        with pytest.raises(SystemExit, match="min-ap50"):
            validate_static_shapes.main(argv)
    else:
        validate_static_shapes.main(argv)
    out = last_json(capsys.readouterr().out)
    assert {"ap", "ap50", "steps", "seed", "sampling", "passed"} <= set(out)
    assert out["sampling"] == "shared_dec0" and out["steps"] == 3
    assert out["passed"] == (out["ap50"] >= min_ap50)
    assert set(out["launches_per_eval_forward"]) == set(quality.EVAL_KERNELS)


def test_quality_campaign_appends_its_line(tmp_path, monkeypatch):
    out = tmp_path / "runs.jsonl"
    argv = ["--device", "cpu", "--variant", "hybrid", "--seed", "0", "--steps", "2", "--eval-every", "1",
            "--canvas", "64", "96", "--n-train", "2", "--n-val", "2",
            "--workdir", str(tmp_path / "data"), "--out", str(out), "--note", "tiny"]
    monkeypatch.setenv("MSDA_GATHER_QUANT", "none")
    result = quality_campaign.main(argv)
    assert os.environ["MSDA_GATHER_QUANT"] == "none"  # the overlay puts the switch back
    lines = out.read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert {"variant", "seed", "steps", "canvas", "batch", "backbone", "curve", "img_s", "int8_curve"} <= set(result)
    assert [c["step"] for c in result["curve"]] == [c["step"] for c in result["int8_curve"]] == [1, 2]
    assert result["int8_ap_gap"] == [round(a["ap"] - b["ap"], 4) for a, b in zip(result["curve"],
                                                                                   result["int8_curve"])]
    assert result["card"] == "cpu" and result["mixed_precision"] == "no" and result["note"] == "tiny"
    assert "fp16_skipped_steps" not in result
    result = quality_campaign.main([a if a != "hybrid" else "exact" for a in argv])
    assert "int8_curve" not in result and len(out.read_text().splitlines()) == 2


def test_quality_campaign_runs_the_int8_overlay_under_fp16(tmp_path, monkeypatch):
    """B8 takes float16 values (ROADMAP C-29, repaired): a hybrid run under
    ``--mixed-precision fp16`` evaluates its weights with the int8 overlay
    too.  On the CPU the campaign's model runs in float32 (the fp16 int8
    core itself is held against the JAX core in test_torch_port_msda_q8.py)."""
    out = tmp_path / "runs.jsonl"
    monkeypatch.setenv("MSDA_GATHER_QUANT", "none")
    result = quality_campaign.main(["--device", "cpu", "--variant", "hybrid", "--seed", "0", "--steps", "1",
                                    "--eval-every", "1", "--canvas", "64", "96", "--n-train", "2", "--n-val", "2",
                                    "--workdir", str(tmp_path / "data"), "--out", str(out),
                                    "--mixed-precision", "fp16"])
    assert [c["step"] for c in result["int8_curve"]] == [1]
    assert set(result["launches_per_eval_forward"]) == {"none", "int8"}
    assert json.loads(out.read_text().splitlines()[0]) == result
