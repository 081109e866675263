"""The pieces of the port's data parallelism that run in one process: the
launcher's variables and ``init_distributed`` (a no-op without them, a raise
for a missing card or a group that cannot form), the rank's rows of a batch
(``shard_batch``), the draws kept at the global shape (CDN, stochastic
depth, the salience noise), the global gt normaliser and CDN group shape,
that every trainable parameter of the tiny model gets a gradient in a train
step (so DDP runs without ``find_unused_parameters``), and the stop flag of a
one-process step; then one case on 2 gloo ranks: a ``GradScaler`` skips on
every rank the step whose gradient was infinite on one."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from salience_detr_torch.data.loader import pack_batch, train_to_device
from salience_detr_torch.models.bricks.criterion import SalienceCriterion, Shard, Targets, global_counts, normaliser
from salience_detr_torch.models.bricks.denoising import cdn_draws, cdn_meta, rows_of
from salience_detr_torch.models.layers import DropPath
from salience_detr_torch.parallel import mesh as mesh_mod
from salience_detr_torch.parallel.mesh import LAUNCHER_VARS, Mesh, init_distributed, mean_over_ranks, shard_batch
from salience_detr_torch.tools.ddp_check import ROOT, free_port
from tests.test_torch_port_ddp_step import global_batches
from tests.torch_port_common import two_torch_threads  # noqa: F401


@pytest.fixture
def no_launcher(monkeypatch):
    for v in LAUNCHER_VARS:
        monkeypatch.delenv(v, raising=False)


def test_without_the_launcher_nothing_is_joined(no_launcher):
    mesh = init_distributed("cpu")
    assert mesh == Mesh() and not mesh.distributed and mesh.rows(4) == [0, 1, 2, 3]
    assert mesh.all_gather_object({"a": 1}) == [{"a": 1}] and mesh.broadcast_object(3) == 3
    mesh.barrier()
    assert not torch.distributed.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cuda_without_a_card_raises(no_launcher, monkeypatch):
    with pytest.raises(RuntimeError, match="device cuda requested"):
        init_distributed("cuda")
    for v, x in zip(LAUNCHER_VARS, ("1", "2", "1", "127.0.0.1", "1")):
        monkeypatch.setenv(v, x)
    with pytest.raises(RuntimeError, match=r"rank 1: device cuda:1 \(LOCAL_RANK\) requested but 0 CUDA devices"):
        init_distributed("cuda")
    assert not torch.distributed.is_initialized()


def test_a_group_that_cannot_form_raises():
    """Rank 0 of 2 whose peer never comes: the store times out and the
    process fails; it does not go on as a single process."""
    code = ("from salience_detr_torch.parallel.mesh import init_distributed\n"
            "init_distributed('cpu', timeout_s=3)\nprint('carried on')\n")
    env = dict(os.environ, RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "carried on" not in proc.stdout
    assert "Error" in proc.stderr


def test_shard_batch_takes_the_rows_of_host_and_device_batches():
    batch = global_batches(seed=1, steps=1)[0]
    for A, rows in ((1, [2, 3]), (2, [1, 3])):
        mine = shard_batch(batch, Mesh(rank=1, world=2), A)
        assert mine.keys() == batch.keys()
        for k, v in batch.items():
            np.testing.assert_array_equal(mine[k], v[rows])
        dev = shard_batch(train_to_device(batch, torch.device("cpu")), Mesh(rank=1, world=2), A)
        whole = train_to_device(batch, torch.device("cpu"))
        assert dev["targets"].counts == tuple(whole["targets"].counts[i] for i in rows)
        torch.testing.assert_close(dev["images"], whole["images"][rows])
        torch.testing.assert_close(dev["targets"].boxes, whole["targets"].boxes[rows])
        assert dev["targets"].shard is None


def test_global_counts_give_the_normaliser_and_the_cdn_shape():
    local = Targets(torch.zeros(2, 4, dtype=torch.long), torch.zeros(2, 4, 4), torch.zeros(2, 4, dtype=torch.bool),
                    (1, 0))
    assert global_counts(local) == (1, 0) and normaliser(local) == 1.0
    sharded = local._replace(shard=Shard((3, 1, 1, 0), 2, 2))
    assert global_counts(sharded) == (3, 1, 1, 0)
    assert normaliser(sharded) == 5 / 2  # max(global count, 1) over the world size
    assert cdn_meta(global_counts(sharded), 4) == (3, 1) != cdn_meta(local.counts, 4)
    empty = local._replace(counts=(0, 0), shard=Shard((0, 0, 0, 0), 0, 2))
    assert normaliser(empty) == 0.5  # the clamp to 1 before the division


def test_draws_at_the_global_shape_keep_each_image_its_noise():
    whole = cdn_draws(4, 8, 5, 0.5, torch.Generator().manual_seed(3), "cpu")
    mine = rows_of(cdn_draws(4, 8, 5, 0.5, torch.Generator().manual_seed(3), "cpu"), 2, 2)
    for a, b in zip(mine, whole):
        assert torch.equal(a, b[2:4])
    drop = DropPath(0.5).train()
    x = torch.ones(4, 3, 2, 2)
    drop.generator = torch.Generator().manual_seed(9)
    want = drop(x)
    drop.generator, drop.rows = torch.Generator().manual_seed(9), (2, 4)
    assert torch.equal(drop(x[2:]), want[2:])
    assert not torch.equal(want[2:], want[:2])


def test_salience_noise_draws_at_the_global_shape():
    """A rank's salience criterion draws the noise at the global batch's
    shape, the same draws as one process on the whole batch (the rank keeps
    its rows of them)."""
    crit = SalienceCriterion(noise_scale=1.0)
    g = torch.Generator().manual_seed(1)
    masks = [torch.randn(4, 3, 4, 1, generator=g), torch.randn(4, 2, 2, 1, generator=g)]
    boxes = torch.rand(4, 2, 4, generator=g) * 0.3 + 0.2
    valid = torch.ones(4, 2, dtype=torch.bool)
    targets = Targets(torch.zeros(4, 2, dtype=torch.long), boxes, valid, (2, 2, 2, 2))
    sizes = torch.tensor([[96, 128]] * 4)
    strides = [(32.0, 32.0), (48.0, 64.0)]
    drawn = []
    real_rand = torch.rand

    def recording_rand(*a, **k):
        drawn.append(real_rand(*a, **k))
        return drawn[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "rand", recording_rand)
        crit(masks, targets, strides, sizes, generator=torch.Generator().manual_seed(5))
        whole = list(drawn)
        drawn.clear()
        rank1 = targets._replace(labels=targets.labels[2:], boxes=boxes[2:], valid=valid[2:], counts=(2, 2),
                                 shard=Shard((2, 2, 2, 2), 2, 1))
        crit([m[2:] for m in masks], rank1, strides, sizes[2:], generator=torch.Generator().manual_seed(5))
    assert [tuple(d.shape) for d in drawn] == [tuple(d.shape) for d in whole] == [(4, 12), (4, 4)]
    for a, b in zip(drawn, whole):
        assert torch.equal(a, b)


def test_every_trainable_parameter_gets_a_gradient_in_a_train_step():
    from salience_detr_torch.engine.optim import build_optimizer, make_lr_schedule
    from salience_detr_torch.models.bricks.criterion import default_weight_dict
    from salience_detr_torch.models.factory import SalienceDETRConfig, build_criteria, build_salience_detr
    from salience_detr_torch.parallel.train_step import make_train_step
    from tests.torch_port_common import TINY_TORCH

    cfg = SalienceDETRConfig(**TINY_TORCH)
    model, _ = build_salience_detr(cfg, torch.device("cpu"), torch.Generator().manual_seed(0))
    crit, sal = build_criteria(cfg)
    step = make_train_step(model, crit, sal, build_optimizer(model, 1e-4, 1e-4, (0.9, 0.999)),
                           make_lr_schedule(1e-4, 10), default_weight_dict(cfg.num_decoder_layers))
    batch = train_to_device(global_batches(seed=2, steps=1, counts=(2, 0, 1, 3))[0], torch.device("cpu"))
    step(batch, torch.Generator().manual_seed(0))
    trainable = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert len(trainable) > 300
    assert [n for n, p in trainable if p.grad is None] == []


def test_one_process_step_stops_on_its_own_flag_and_logs_its_own_metrics():
    from salience_detr_torch.parallel.train_step import TrainStep

    step = TrainStep.__new__(TrainStep)
    step.mesh, step.stop_source, step._agreed_stop = None, None, False
    assert not step.should_stop()
    flag = [False]
    step.stop_source = lambda: flag[0]
    flag[0] = True
    assert step.should_stop()
    metrics = {"loss": torch.tensor(2.0)}
    assert mean_over_ranks(metrics) is metrics
    assert mesh_mod.all_reduce_sum(metrics["loss"]) is metrics["loss"]


def test_pack_batch_rows_and_whole_batch_agree():
    """The loader packs only the rank's rows: the same arrays as the rows of
    the whole batch's."""
    rng = np.random.default_rng(0)
    samples = [{"image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                "boxes": np.asarray([[1, 2, 10, 12]], np.float32)[:n], "labels": np.asarray([2])[:n]}
               for (h, w), n in (((40, 50), 1), ((30, 60), 0), ((64, 64), 1), ((20, 20), 1))]
    whole = pack_batch(samples, (64, 64), 3)
    part = pack_batch([samples[i] for i in (1, 3)], (64, 64), 3)
    for k, v in whole.items():
        if k != "image_ids":
            np.testing.assert_array_equal(part[k], v[[1, 3]])


def test_an_infinite_gradient_on_one_rank_skips_the_step_on_every_rank(tmp_path):
    """A ``GradScaler`` on each of 2 ranks: rank 1's first step gets an
    infinite gradient in one parameter; the all-reduce hands it to rank 0,
    so both scalers skip that step (weights unchanged, the scale halved) and
    the ranks stay equal; the second step steps on both."""
    import json

    from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr
    from salience_detr_torch.tools import ddp_check
    from tests.torch_port_common import TINY_TORCH

    spec = tmp_path / "spec"
    spec.mkdir()
    model, _ = build_salience_detr(SalienceDETRConfig(**TINY_TORCH), torch.device("cpu"),
                                   torch.Generator().manual_seed(0))
    (spec / "config.json").write_text(json.dumps(TINY_TORCH))
    (spec / "settings.json").write_text(json.dumps(dict(lr=1e-4, weight_decay=1e-4, betas=[0.9, 0.999], max_norm=0.1,
                                                        steps_per_epoch=10, seed=0, scaler=True, poison_rank=1)))
    torch.save(model.state_dict(), spec / "state.pt")
    batches = global_batches(seed=5, steps=2)
    np.savez(spec / "batches.npz", **{k: np.stack([b[k] for b in batches]) for k in batches[0]})
    out = tmp_path / "ranks"
    out.mkdir()
    ddp_check.launch(["-m", "salience_detr_torch.tools.ddp_check", "step", "--spec", str(spec), "--out", str(out),
                      "--device", "cpu"], world=2, timeout=300, env={"OMP_NUM_THREADS": "2"})
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(2)]
    init = sum(float(p.detach().double().sum()) for p in model.parameters())
    for r in ranks:
        assert r["scales"] == [32768.0, 32768.0]
        assert r["checksums"][0] == init != r["checksums"][1]
        assert not np.isfinite(r["metrics"][0]["grad_norm"]) and np.isfinite(r["metrics"][1]["grad_norm"])
    assert ranks[0]["checksums"] == ranks[1]["checksums"]
    for k, v in ranks[0]["state"].items():
        assert torch.equal(ranks[1]["state"][k], v), k
