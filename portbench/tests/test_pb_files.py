"""BENCHMARK.json against the files it names: every configuration, traffic
mix, limits file and per-layer reader exists; each configuration's fields
are the program's config file's; the reference groups the parameters for
AdamW as the program does."""

import json

import pytest
import torch

from portbench.harness import common


def test_every_piece_is_found():
    bench = common.benchmark()
    for w in bench["workloads"]:
        cell = common.cell(w["name"])
        assert cell["traffic"]["kind"] in ("serve", "train")
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(common.load_reader(m["name"]))
            assert any(e["name"] == m["moves"] for e in cell["end_to_end"]), (w["name"], m["name"])
        for k, v in cell["limits"].items():
            assert v >= 0, k


@pytest.mark.parametrize("name", ["sdetr_r50", "sdetr_r50_5scale"])
def test_config_is_the_programs(name):
    from salience_detr_torch.inference import load_config

    conf = json.loads((common.BENCH / "configs" / f"{name}.json").read_text())
    cfg = load_config(common.ROOT / conf["port_config"])
    for k, v in conf["model"].items():
        got = getattr(cfg, k)
        as_list = json.loads(json.dumps(got)) if isinstance(got, (tuple, list)) else got
        assert as_list == v, k
    assert str(cfg.dtype) == f"torch.{conf['dtype']}"
    for canvas in ("800x1344",):
        assert 3 * conf["flops"]["serve"][canvas] > conf["flops"]["train"][canvas] > 2 * conf["flops"]["serve"][canvas] > 0


def test_param_groups_are_the_programs():
    from salience_detr_torch.engine.optim import named_param_groups as program_groups
    from salience_detr_torch.models.factory import build_salience_detr

    from portbench.reference import model as rm
    from portbench.reference.optim import named_param_groups
    from portbench.tests.tiny import tiny_cell

    cell, cfg = tiny_cell("train")
    program, _ = build_salience_detr(cfg, torch.device("cpu"))
    ref = rm.build(cell["config"]["model"], "cpu")
    assert named_param_groups(ref) == program_groups(program)
