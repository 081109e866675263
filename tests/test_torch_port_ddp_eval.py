"""The evaluator's merge across the ranks of a data-parallel run, the port's
twin of tests/test_multihost_eval.py: two gloo processes, each scoring half
of the images, merge their predictions through ``Mesh.all_gather_object``
(``CocoEvaluator.synchronize_between_processes``) and both hold the stats of
one process scoring every image.  Then the eval CLI (python -m
salience_detr_torch.test --device cpu) under the launcher's variables on 2
ranks against one process, on the tiny config: the same predictions (the
ranks forward the one-process batches), so the same stats, and one result
file, written by rank 0."""

import json

import numpy as np
import pytest

from salience_detr_torch import test as eval_entry
from salience_detr_torch.data.coco import CocoIndex
from salience_detr_torch.tools import ddp_check
from salience_detr_torch.utils.coco_eval import CocoEvaluator
from tests.test_multihost_eval import ANN, PREDS
from tests.torch_port_common import TINY_TORCH, write_coco_split
from tests.torch_port_common import two_torch_threads  # noqa: F401

WORKER = r"""
import json, sys
import numpy as np
from salience_detr_torch.data.coco import CocoIndex
from salience_detr_torch.parallel.mesh import init_distributed, shutdown
from salience_detr_torch.utils.coco_eval import CocoEvaluator

workdir = sys.argv[1]
mesh = init_distributed("cpu")
index = CocoIndex(json.load(open(f"{workdir}/ann.json")))
preds = {int(k): v for k, v in json.load(open(f"{workdir}/preds.json")).items()}
ev = CocoEvaluator(index)
ev.update({k: {kk: np.asarray(vv, float) for kk, vv in v.items()} for k, v in preds.items()
           if k % mesh.world == mesh.rank})
ev.synchronize_between_processes(mesh.all_gather_object)
assert sorted(ev.img_ids) == sorted(index.img_ids), ev.img_ids
ev.accumulate()
json.dump(ev.summarize(), open(f"{workdir}/stats{mesh.rank}.json", "w"))
shutdown(mesh)
"""


def test_merged_stats_equal_one_process(tmp_path):
    (tmp_path / "ann.json").write_text(json.dumps(ANN))
    (tmp_path / "preds.json").write_text(json.dumps(PREDS))
    ddp_check.launch(["-c", WORKER, str(tmp_path)], world=2, timeout=120)
    ev = CocoEvaluator(CocoIndex(ANN))
    ev.update({k: {kk: np.asarray(vv, float) for kk, vv in v.items()} for k, v in PREDS.items()})
    ev.accumulate()
    want = ev.summarize()
    assert 0 < want["AP"] < 1
    for r in range(2):
        assert json.loads((tmp_path / f"stats{r}.json").read_text()) == want


EVAL_SIZES = [(96, 128), (128, 96), (61, 47), (70, 101), (96, 120), (80, 60), (90, 128)]


@pytest.fixture(scope="module")
def eval_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_eval_cli")
    img_dir, ann = write_coco_split(root, EVAL_SIZES, seed=6, fmt="npy", counts=[2, 1, 3, 0, 2, 1, 4])
    model = root / "tiny_model.py"
    model.write_text("from salience_detr_torch.models.factory import SalienceDETRConfig\n"
                     f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n")
    return root, img_dir, ann, model


def sorted_results(path):
    return sorted(json.loads(path.read_text()), key=lambda r: (r["image_id"], -r["score"], r["category_id"]))


def test_eval_cli_on_two_ranks_equals_one_process(eval_split):
    root, img_dir, ann, model = eval_split
    args = ["--coco-img", str(img_dir), "--coco-ann", str(ann), "--model-config", str(model),
            "--batch-size", "2", "--seed", "3", "--device", "cpu"]
    one = root / "one" / "results.json"
    one.parent.mkdir()
    stats = eval_entry.main(args + ["--save-results", str(one)])
    out = root / "ranks"
    out.mkdir()
    done = ddp_check.launch(["-m", "salience_detr_torch.test", *args, "--save-results", str(out / "results.json")],
                            world=2, timeout=300, env={"OMP_NUM_THREADS": "2"})
    assert [p.name for p in out.iterdir()] == ["results.json"]
    assert sorted_results(out / "results.json") == sorted_results(one)
    assert len(json.loads(one.read_text())) > 0
    # rank 0 logs the merged stats, rank 1 nothing
    line = [x for x in done[0].stdout.splitlines() if " AP=" in x]
    assert line and line[-1].endswith(" ".join(f"{k}={v:.4f}" for k, v in stats.items()))
    assert done[1].stdout == ""
    assert eval_entry.rescore_result_file(CocoIndex(str(ann)), str(out / "results.json")) == stats
