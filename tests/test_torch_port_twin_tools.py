"""The twins of the JAX package's last root tools, on the CPU at tiny sizes:
the parity runbook's upstream-layout ``.pth`` against the JAX converter's
export of the same config, loaded strictly by the port's eval CLI in a
subprocess; a CPU trace of the tiny model reported by region, adding up to
its total and naming the JAX package's scopes; the backbone bench's batch
probe, which only an out-of-memory error ends; the loader bench's epoch and
JSON line; and the campaign report against the JAX tool's printout."""

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from salience_detr_tpu.models.factory import SalienceDETRConfig as JaxConfig
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_tpu.utils import weight_converter as jax_wc
from salience_detr_torch.models.factory import SalienceDETRConfig
from salience_detr_torch.tools import (
    backbone_bench,
    bench_loader,
    parity_runbook,
    profile_trace,
    quality_campaign_report,
    trace_report,
)
from tests.test_torch_port_weights import jax_rules
from tests.torch_port_common import TINY, TINY_TORCH, jax_variable_shapes, random_variables
from tests.torch_port_common import two_torch_threads  # noqa: F401 (an autouse fixture)

ROOT = Path(__file__).resolve().parent.parent
# the named scopes of the JAX package's forward (salience_detr.py:80-85,
# salience_transformer.py:438-615) that the tiny model passes through
# (prefix_sort runs only with sort_encoder_prefix, which the port leaves out)
JAX_SCOPES = {"backbone", "channel_mapper", "masks_pos_embeds", "flatten_inputs", "backbone_memory_proj",
              "salience_cascade", "salience_sort", "encoder_layer_0", "encoder_layer_1", "background_embed",
              "repnet_neck", "two_stage_heads", "proposal_topk", "proposal_nms", "decoder_layer_0",
              "decoder_layer_1"}


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.py"
    path.write_text("from salience_detr_torch.models.factory import SalienceDETRConfig\n"
                    f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n")
    return str(path)


def test_runbook_writes_the_jax_exports_keys_and_the_cli_loads_them_strictly(tiny_config, tmp_path):
    """The runbook's ``.pth`` at tiny dims holds every tensor the JAX
    package's ``export_torch_state_dict`` writes for the same exact-sampling
    config, at the same shapes, and beside them only the BatchNorm counters
    (``num_batches_tracked``) that a PyTorch state dict carries and the JAX
    export leaves out; the eval CLI (``--device cpu`` subprocess) loads it
    with ``strict=True`` and prints an AP line."""
    r = parity_runbook.main(["--model-config", tiny_config, "--workdir", str(tmp_path), "--n-images", "2",
                             "--batch-size", "2", "--canvas", "96", "128", "--device", "cpu", "--timeout", "300"])
    assert r["passed"] and r["strict_load_in_cli"] and r["conversion"]["share"] == 1.0
    assert r["ap_line"].startswith("AP=") and r["eval_batches"] == 1 and r["launches"] == {}
    assert r["real_weights_command"].startswith("python -m salience_detr_torch.test --model-config")

    jmodel, *_ = build_jax(JaxConfig(**dict(TINY, shared_sampling_locations=False, denoising_nums=4)))
    variables = random_variables(jax_variable_shapes(jmodel), seed=3)
    want, skipped = jax_wc.export_torch_state_dict(variables, jax_rules(SalienceDETRConfig(**TINY_TORCH)))
    got = torch.load(tmp_path / "synthesized_full_dims.pth", weights_only=True)["model"]
    assert not skipped and len(got) == r["tensors_written"]
    assert {k: tuple(np.shape(v)) for k, v in want.items()} == {k: tuple(got[k].shape) for k in want}
    extra = set(got) - set(want)
    assert extra and all(k.endswith(".num_batches_tracked") for k in extra)
    assert json.loads((tmp_path / "parity_runbook.json").read_text())["conversion"]["total"] == len(got)


@pytest.mark.parametrize("mode", ["inference", "train"])
def test_trace_report_adds_up_and_names_the_jax_scopes(tiny_config, tmp_path, mode):
    """A CPU trace of the tiny model's forward (and train step): the rows
    and the unattributed row add up to the trace's total, and the regions
    name every JAX scope the model passes through; the train step's
    backward lands in the forward's regions."""
    cfg = profile_trace.model_config(tiny_config, "shared_dec0")
    assert (cfg.encoder_sampling_groups, cfg.decoder_sampling_groups) == (1, None)
    meta = profile_trace.trace(mode, cfg, torch.device("cpu"), 2, (96, 128), 1, tmp_path)
    assert meta["iters"] == 1 and meta["device"] == "cpu" and meta["card"] is None
    r = trace_report.main(["--trace", str(tmp_path / "trace.json"), "--depth", "8"])
    assert r["total_ms"] > 0 and abs(r["check_ms"]) <= 1e-9 * r["total_ms"]
    assert JAX_SCOPES <= {seg for key in r["rows"] for seg in key.split("/")}
    if mode == "train":
        assert sum(bwd for _, bwd in r["rows"].values()) > 0
        assert {"criterion", "salience_criterion"} <= {key.split("/")[0] for key in r["rows"]}
    shallow = trace_report.report(str(tmp_path / "trace.json"), 1, depth=1, out=io.StringIO())
    assert abs(sum(ms for ms, _ in shallow["rows"].values()) + shallow["unattributed_ms"] - r["total_ms"]) < 1e-6


def test_sampling_grammar_is_bench_pys():
    assert profile_trace.sampling_cfg("shared_dec0") == (1, 0)
    assert profile_trace.sampling_cfg("groups4") == (4, -1)
    assert profile_trace.sampling_cfg("exact") == (0, -1)


def test_batch_probe_ends_only_at_out_of_memory():
    """The JAX tool counts any exception as the OOM boundary (ADVICE.md);
    here a ValueError propagates, an OutOfMemoryError ends the probe, and
    the bound ends it without one."""
    def fails_at(bad, error):
        def forward_at(b):
            if b >= bad:
                raise error
        return forward_at

    with pytest.raises(ValueError):
        backbone_bench.probe_max_batch(fails_at(8, ValueError("a bug, not memory")), 2, 64)
    assert backbone_bench.probe_max_batch(fails_at(16, torch.cuda.OutOfMemoryError("out")), 2, 64) == (8, 16)
    assert backbone_bench.probe_max_batch(fails_at(1 << 20, ValueError), 2, 16) == (16, None)
    assert backbone_bench.probe_max_batch(fails_at(128, torch.cuda.OutOfMemoryError("out")), 2, 0) == (64, 128)


@pytest.mark.parametrize("groups", [1, 64])
def test_step_flops_count_a_grouped_convs_backward_once(groups):
    """A convolution's backward costs twice its forward (input and weight
    gradients); torch's counter counts a depthwise convolution's weight
    gradient 64 times over, the bench's counter once."""
    conv = torch.nn.Conv2d(64, 64, 7, padding=3, groups=groups, bias=False)
    x = torch.randn(1, 64, 16, 16, requires_grad=True)
    forward = 2 * 64 * (64 // groups) * 49 * 16 * 16
    mode = backbone_bench.step_flop_counter()
    with mode:
        conv(x).sum().backward()
    assert mode.get_total_flops() == 3 * forward


def test_loader_bench_epoch_holds_every_image_once_and_its_line(tmp_path, capsys):
    img_dir, ann, fmt = bench_loader.write_split(str(tmp_path), 8)
    assert fmt in ("jpg", "npy") and len(list(Path(img_dir).iterdir())) == 8
    loader = bench_loader.make_loader(img_dir, ann, "basic", 4, (800, 1344), 2)
    ids = bench_loader.epoch_ids(loader, 0)
    assert sorted(ids) == list(range(8))  # the JAX tool's images are all landscape: no orientation pool is cut
    lines = bench_loader.main(["--num-images", "8", "--epochs", "1", "--num-workers", "2", "--transform", "basic",
                               "strong_album+copypaste"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == lines and [r["transform"] for r in lines] == ["basic", "strong_album+copypaste"]
    for r in lines:
        assert r["metric"] == "loader_img_s" and r["unit"] == "img/s" and r["value"] > 0 and r["images"] > 0
        assert r["image_format"] == fmt and r["num_workers"] == 2 and r["worker_ms_a_sample"] > 0
    with pytest.raises(ValueError, match="copypaste"):
        bench_loader.make_loader(img_dir, ann, "basic+mosaic", 4, (800, 1344), 2)


def test_campaign_report_rows_equal_the_jax_tools(tmp_path):
    """On lines in the JAX tool's format (two seeds, an exact and a hybrid
    run each, the hybrids with the int8 overlay) the header, the paired rows
    and the means are the JAX tool's printout (the JAX tool imports no JAX:
    it runs as a subprocess); a variant of one seed says so."""
    rng = np.random.default_rng(0)

    def curve():
        return [{"step": s, "ap": float(round(rng.uniform(0.3, 0.9), 4)), "ap50": 0.9} for s in (500, 1000, 1500)]

    runs = [{"variant": v, "seed": s, "steps": 1500, "curve": curve(), "img_s": 3.1, **(
        {"int8_curve": curve()} if v == "hybrid" else {})} for s in (0, 1) for v in ("exact", "hybrid")]
    runs.append({"variant": "hybrid", "seed": 0, "steps": 1500, "curve": curve(), "img_s": 3.0,
                 "mixed_precision": "fp16"})
    path = tmp_path / "campaign.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in runs[:4]) + "\n")
    jax_out = subprocess.run([sys.executable, "tools/quality_campaign_report.py", str(path)], cwd=ROOT,
                             capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()
    ours = quality_campaign_report.report(str(path))
    table = jax_out[:jax_out.index("AP curves:")]
    assert ours[:len(table)] == table and any(line.startswith("   1 ") for line in table)
    assert not any("one seed" in line for line in ours)

    path.write_text("\n".join(json.dumps(r) for r in runs) + "\n")
    ours = quality_campaign_report.report(str(path))
    assert ours[:len(table)] == [f"5 runs, seeds [0, 1]"] + table[1:]
    assert [line for line in ours if "one seed" in line] == [
        line for line in ours if line.lstrip().startswith("hybrid fp16")]
