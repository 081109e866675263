"""``salience_detr_torch/tools/finetune_rehearsal.py`` at a tiny size on the
CPU: pretrain, the ``.pth``, fine-tune through the tolerant merge, the
scratch run and the JSON-less eval all run; the JSON fields, the pass rule,
and the merge skipping exactly the tensors whose shape the class count sets
(the class heads and the CDN label table)."""

import json
import sys

import pytest

from salience_detr_torch.tools import finetune_rehearsal
from tests.torch_port_common import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune")
    out = root / "result.json"
    saved = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None  # the tracker writes metrics.jsonl (no TensorFlow import)
    try:
        try:
            finetune_rehearsal.main(["--device", "cpu", "--pretrain-epochs", "1", "--finetune-epochs", "1",
                                     "--images", "4", "2", "4", "2", "--workdir", str(root), "--out", str(out)])
            exited = None
        except SystemExit as e:
            exited = str(e)
    finally:
        if saved is None:
            sys.modules.pop("torch.utils.tensorboard", None)
        else:
            sys.modules["torch.utils.tensorboard"] = saved
    return json.loads(out.read_text()), exited, root


def test_fields_and_rule(rehearsal):
    result, exited, _ = rehearsal
    assert set(result) == {"pretrain_ap50", "finetune_ap50", "scratch_ap50", "uplift", "jsonless_ap50",
                           "platform", "passed", "merge_skipped"}
    assert result["passed"] == (result["finetune_ap50"] > result["scratch_ap50"]) == (exited is None)
    assert result["uplift"] == round(result["finetune_ap50"] - result["scratch_ap50"], 4)
    assert result["platform"] == "cpu"


def test_merge_skips_the_class_count_tensors(rehearsal):
    import torch

    result, _, root = rehearsal
    state = torch.load(root / "pretrained_base.pth", weights_only=True)
    sized_by_classes = sorted(k for k, v in state.items() if v.ndim and v.shape[0] == 7)
    assert result["merge_skipped"] == sized_by_classes
    assert any("class_head" in k for k in sized_by_classes) and "denoising_generator.label_encoder.weight" in \
        sized_by_classes


def test_every_run_wrote_its_checkpoints(rehearsal):
    _, _, root = rehearsal
    for name in ("pretrain", "finetune", "scratch"):
        assert (root / name / "checkpoints" / "0.pth").exists()
        assert json.loads((root / name / "summary.json").read_text())["epochs"] == [0]
