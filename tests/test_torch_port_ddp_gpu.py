"""Card-only cases of the port's data parallelism (marked ``gpu``; they skip
without a CUDA device): two ranks on one card over gloo
(``salience_detr_torch.tools.ddp_check``, LOCAL_RANK 0 for both; NCCL
refuses two ranks on one device).  The synced BatchNorm on CUDA tensors,
split 2+2 and 1+1, against the port's ``BatchNorm2d`` on the whole batch on
the card (rtol 1e-5 / atol 1e-5, TF32 off); and 2 train steps of a small
model on the card (the MSDA, grid-NMS and assignment kernels), data-parallel
against the one-process step on the whole batches, the CDN draws made by
each rank's generator at the global shape: metrics at rtol 1e-4 / atol 1e-5
and every state tensor within 1e-3 of what the steps moved plus an ulp (the
MSDA backward's float atomics add in another order on each run).  This
file imports torch, numpy and the port only: it runs on the card's machine
with ``--noconftest``."""

import json

import numpy as np
import pytest
import torch

from salience_detr_torch.data.loader import pack_batch
from salience_detr_torch.models.bricks.attention import MultiScaleDeformableAttention
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr
from salience_detr_torch.models.layers import BatchNorm2d
from salience_detr_torch.parallel.mesh import Mesh
from salience_detr_torch.tools import ddp_check

SMALL = dict(
    backbone="resnet18", embed_dim=32, num_classes=5, num_queries=24,
    num_encoder_layers=2, num_decoder_layers=2, num_heads=4, dim_feedforward=64,
    topk_sa=12, layer_filter_ratio=(1.0, 0.5), max_num_embedding=16,
    encoder_sampling_groups=1, min_size=96, max_size=128, select_box_nums_for_evaluation=20, denoising_nums=4,
)
CANVAS = (96, 128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [4, 2], ids=["split_2_2", "split_1_1"])
def test_synced_batch_norm_on_the_card(cuda, tmp_path, batch):
    rng = np.random.default_rng(batch)
    C = 16
    d = {"x": (rng.normal(size=(batch, C, 7, 9)) * 2 + 0.5).astype(np.float32),
         "dy": rng.normal(size=(batch, C, 7, 9)).astype(np.float32),
         "weight": rng.uniform(0.5, 1.5, C).astype(np.float32), "bias": rng.normal(size=C).astype(np.float32),
         "running_mean": np.zeros(C, np.float32), "running_var": np.ones(C, np.float32)}
    np.savez(tmp_path / "inputs.npz", **d)
    ddp_check.launch(["-m", "salience_detr_torch.tools.ddp_check", "bn", "--inputs", str(tmp_path / "inputs.npz"),
                      "--out", str(tmp_path), "--device", "cuda"], world=2, one_device=True, timeout=300)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    layer = BatchNorm2d(C).to(cuda).train()
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(d["weight"]))
        layer.bias.copy_(torch.from_numpy(d["bias"]))
    x = torch.from_numpy(d["x"]).to(cuda).requires_grad_(True)
    y = layer(x)
    y.backward(torch.from_numpy(d["dy"]).to(cuda))
    want = {"y": y.detach(), "dx": x.grad, "dweight": layer.weight.grad, "dbias": layer.bias.grad,
            "running_mean": layer.running_mean, "running_var": layer.running_var}
    got = {"y": np.concatenate([r["y"] for r in ranks]), "dx": np.concatenate([r["dx"] for r in ranks]),
           "dweight": ranks[0]["dweight"] + ranks[1]["dweight"], "dbias": ranks[0]["dbias"] + ranks[1]["dbias"],
           "running_mean": ranks[0]["running_mean"], "running_var": ranks[0]["running_var"]}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v.cpu().numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(ranks[0]["running_var"], ranks[1]["running_var"])


def small_spec(root, seed=0, counts=(3, 1, 1, 0), steps=2):
    """A spec directory of ``ddp_check step`` for the small model: random
    init from ``seed`` with the MSDA sampling offsets moved off the pixel
    centres (ROADMAP C-14), ``steps`` global batches of 4 images."""
    cfg = SalienceDETRConfig(**SMALL)
    model, _ = build_salience_detr(cfg, torch.device("cpu"), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MultiScaleDeformableAttention):
                m.sampling_offsets.weight.copy_(torch.randn(m.sampling_offsets.weight.shape, generator=gen) * 0.02)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        samples = []
        for (h, w), n in zip([(96, 128), (70, 101), (90, 120), (80, 128)], counts):
            x0, y0 = rng.uniform(0, 0.5, n) * w, rng.uniform(0, 0.5, n) * h
            bw, bh = rng.uniform(0.1, 0.5, n) * w, rng.uniform(0.1, 0.5, n) * h
            samples.append({"image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                            "boxes": np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(np.float32),
                            "labels": rng.integers(0, 5, n)})
        batches.append(pack_batch(samples, CANVAS, 4))
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(SMALL))
    (root / "settings.json").write_text(json.dumps(dict(lr=1e-4, weight_decay=1e-4, betas=[0.9, 0.999], max_norm=0.1,
                                                        steps_per_epoch=10, accumulate_steps=1, seed=seed)))
    torch.save(model.state_dict(), root / "state.pt")
    np.savez(root / "batches.npz", **{k: np.stack([b[k] for b in batches]) for k in batches[0]})
    return root, model.state_dict()


@pytest.mark.gpu
def test_ddp_step_of_the_small_model_on_the_card(cuda, tmp_path):
    spec, init = small_spec(tmp_path / "spec")
    one = ddp_check.run_step(str(spec), Mesh(device=cuda))
    out = tmp_path / "ranks"
    out.mkdir()
    ddp_check.launch(["-m", "salience_detr_torch.tools.ddp_check", "step", "--spec", str(spec), "--out", str(out),
                      "--device", "cuda"], world=2, one_device=True, timeout=600)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(2)]
    for step, (want, got) in enumerate(zip(one["metrics"], ranks[0]["metrics"])):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5, err_msg=f"step {step} {k}")
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for name, want in one["state"].items():
        got = ranks[0]["state"][name]
        assert torch.equal(got, ranks[1]["state"][name]), name
        if not want.is_floating_point():
            assert torch.equal(got, want), name
            continue
        moved = float((want.float() - init[name].float()).abs().max())
        ulp = float(want.abs().max()) * 2.0**-23
        assert float((got.float() - want.float()).abs().max()) <= 1e-3 * moved + ulp + 1e-7, name
