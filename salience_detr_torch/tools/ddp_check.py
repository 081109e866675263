"""Data-parallel checks: run the port's synced BatchNorm or its train step on
W ranks and write what each rank computed, for a comparison with one process
on the whole batch.

    python -m salience_detr_torch.tools.ddp_check bn --inputs F.npz --out DIR [--device cuda|cpu]
    python -m salience_detr_torch.tools.ddp_check step --spec DIR --out DIR [--device cuda|cpu]
    python -m salience_detr_torch.tools.ddp_check loader --spec F.json --out DIR [--device cuda|cpu]

Each process is one rank, started with the launcher's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; :func:`launch`
sets them, one rank a card or every rank on card 0, and ``torchrun`` does
too).  ``--device`` defaults to cuda, as the port's other entry points do,
and refuses without a card; ``--device cpu`` runs the ranks on the CPU.
``--backend`` picks the process group (gloo by default here: it runs
several ranks on the CPU or on one card; NCCL takes one rank a card), and
``--deterministic`` the numerics of ``--use-deterministic-algorithms``.

* ``bn``: ``F.npz`` holds x and dy (B, C, H, W) float32 and the layer's
  weight, bias and running statistics; rank r takes the r-th of W equal
  row blocks, runs ``layers.BatchNorm2d`` synced over the ranks in train
  mode forward and backward (dy its output's gradient), and writes
  ``rank<r>.npz``: y, dx (its rows), the local weight and bias gradients
  and the running statistics after the step.
* ``step``: ``DIR`` holds ``config.json`` (the model config's fields),
  ``settings.json`` (lr, weight decay, betas, max_norm, steps per epoch,
  accumulate steps, seed; ``scaler``: a ``GradScaler``; ``poison_rank``:
  that rank's first step gets an infinite gradient in one parameter, which
  the all-reduce hands to every rank), ``state.pt`` (the model's state dict),
  ``batches.npz`` (global ``pack_batch`` batches stacked on a first axis)
  and optionally ``draws.pt`` (per step, the CDN draws of each global
  micro-batch); every rank builds the model, loads the state, takes its rows
  of each batch (``shard_batch``) and runs the train step, and writes
  ``rank<r>.pt``: each step's metrics averaged over the ranks, the rank's
  own metrics, the scaler's scale and a checksum of the parameters after
  each step, and the model's state dict after the steps.  Without the
  launcher's variables :func:`run_step` is the one-process step on the whole
  batches, the reference.
* ``loader``: ``F.json`` names a COCO-format split and the ``TrainLoader``'s
  settings (preset, copy-paste, global batch, canvas, max_gt, seed, workers,
  accumulate steps, ``stop_after``); every rank iterates epoch 0 with the
  ranks sharing the preparation (``Mesh.loader_exchange``), stopping after
  ``stop_after`` batches when it is set (the generator closed, as the
  prefetcher closes it), then the whole of epoch 1, and writes
  ``rank<r>.npz``: each epoch's batches (``e<epoch>_<batch>_<key>``), their
  count, and the samples it prepared in each epoch and their seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from salience_detr_torch.parallel.mesh import Mesh, init_distributed, mean_over_ranks, shard_batch, shutdown
from salience_detr_torch.utils.env import configure_numerics

ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(args: Sequence[str], world: int, one_device: bool = False, env: Optional[Dict[str, str]] = None,
          cwd: Optional[str] = None) -> List[subprocess.Popen]:
    """Start ``python args`` as ``world`` ranks of one process group on
    localhost, each with the launcher's variables (LOCAL_RANK 0 for every
    rank with ``one_device``: several ranks on one card)."""
    port = str(free_port())
    procs = []
    for rank in range(world):
        rank_env = dict(os.environ, **(env or {}))
        rank_env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0" if one_device else str(rank),
                        LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        rank_env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), rank_env.get("PYTHONPATH")) if p)
        procs.append(subprocess.Popen([sys.executable, *args], env=rank_env, cwd=cwd or str(ROOT),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def wait(procs: Sequence[subprocess.Popen], timeout: float = 600.0) -> List[subprocess.CompletedProcess]:
    """Wait for every rank (killing those still running after ``timeout``
    seconds in all); raises, with each failed rank's last output, when one
    did not exit 0.  Returns each rank's completed process."""
    done = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            done.append(subprocess.CompletedProcess(p.args, p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [(r, d) for r, d in enumerate(done) if d.returncode != 0]
    if failed or len(done) < len(procs):
        report = "\n".join(f"rank {r} exit {d.returncode}:\n{d.stdout[-2000:]}\n{d.stderr[-4000:]}" for r, d in failed)
        raise RuntimeError(f"ranks failed ({len(done)} of {len(procs)} ended):\n{report}")
    return done


def launch(args: Sequence[str], world: int, one_device: bool = False, timeout: float = 600.0,
           env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None) -> List[subprocess.CompletedProcess]:
    """:func:`start` and :func:`wait`."""
    return wait(start(args, world, one_device, env, cwd), timeout)


def bn_rank(inputs: str, out: str, device: str, backend: str):
    from salience_detr_torch.models.layers import BatchNorm2d, sync_batch_norm

    mesh = init_distributed(device, backend)
    try:
        data = np.load(inputs)
        B = data["x"].shape[0]
        if B % mesh.world:
            raise ValueError(f"batch {B} is not divisible by {mesh.world} ranks")
        rows = slice(mesh.rank * B // mesh.world, (mesh.rank + 1) * B // mesh.world)
        dev = mesh.device
        layer = BatchNorm2d(data["x"].shape[1]).to(dev)
        with torch.no_grad():
            for name in ("weight", "bias", "running_mean", "running_var"):
                getattr(layer, name).copy_(torch.from_numpy(data[name]))
        sync_batch_norm(layer, torch.distributed.group.WORLD)
        layer.train()
        x = torch.from_numpy(data["x"][rows]).to(dev).requires_grad_(True)
        y = layer(x)
        y.backward(torch.from_numpy(data["dy"][rows]).to(dev))
        np.savez(Path(out) / f"rank{mesh.rank}.npz", y=y.detach().cpu().numpy(), dx=x.grad.cpu().numpy(),
                 dweight=layer.weight.grad.cpu().numpy(), dbias=layer.bias.grad.cpu().numpy(),
                 running_mean=layer.running_mean.cpu().numpy(), running_var=layer.running_var.cpu().numpy())
    finally:
        shutdown(mesh)


def load_spec(spec: str):
    d = Path(spec)
    config = json.loads((d / "config.json").read_text())
    settings = json.loads((d / "settings.json").read_text())
    state = torch.load(d / "state.pt", map_location="cpu", weights_only=True)
    data = np.load(d / "batches.npz")
    batches = [{k: data[k][i] for k in data.files} for i in range(data["images"].shape[0])]
    draws = torch.load(d / "draws.pt", weights_only=True) if (d / "draws.pt").exists() else None
    return config, settings, state, batches, draws


def run_step(spec: str, mesh: Mesh) -> Dict:
    """The spec's steps on this rank (the whole batches in one process);
    returns {"metrics": [averaged per step], "local": [per step],
    "state": state dict after the steps}."""
    from salience_detr_torch.data.loader import train_to_device
    from salience_detr_torch.engine.optim import build_optimizer, make_lr_schedule
    from salience_detr_torch.models.bricks.criterion import default_weight_dict
    from salience_detr_torch.models.bricks.denoising import CDNDraws
    from salience_detr_torch.models.factory import SalienceDETRConfig, build_criteria, build_salience_detr
    from salience_detr_torch.parallel.train_step import make_train_step

    config, settings, state, batches, draws = load_spec(spec)
    cfg = SalienceDETRConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in config.items()})
    dev = mesh.device
    model, _ = build_salience_detr(cfg, dev, torch.Generator().manual_seed(settings.get("seed", 0)))
    model.load_state_dict(state, strict=True)
    criterion, salience_criterion = build_criteria(cfg)
    optimizer = build_optimizer(model, settings["lr"], settings["weight_decay"], tuple(settings["betas"]))
    schedule = make_lr_schedule(settings["lr"], settings["steps_per_epoch"], [10], 0.1, 1e-3,
                                min(1000, settings["steps_per_epoch"]))
    A = settings.get("accumulate_steps", 1)
    scaler = torch.amp.GradScaler(dev.type) if settings.get("scaler") else None
    step = make_train_step(model, criterion, salience_criterion, optimizer, schedule,
                           default_weight_dict(cfg.num_decoder_layers), settings["max_norm"],
                           accumulate_steps=A, scaler=scaler, mesh=mesh)
    generator = torch.Generator(dev).manual_seed(settings.get("seed", 0))
    averaged, local, scales, checksums = [], [], [], []
    poison = None
    if settings.get("poison_rank") == mesh.rank:
        param = next(p for p in model.parameters() if p.requires_grad)
        poison = param.register_hook(lambda g: torch.full_like(g, float("inf")))
    for i, batch in enumerate(batches):
        device_batch = train_to_device(batch, dev)
        if mesh.distributed:
            device_batch = shard_batch(device_batch, mesh, A)
        step_draws = None
        if draws is not None:
            step_draws = [CDNDraws(*(x.to(dev) for x in d)) for d in draws[i]]
        metrics = step(device_batch, generator, draws=step_draws)
        if poison is not None:
            poison.remove()
            poison = None
        local.append({k: float(v) for k, v in metrics.items()})
        averaged.append({k: float(v) for k, v in mean_over_ranks(metrics).items()})
        scales.append(scaler.get_scale() if scaler is not None else None)
        checksums.append(sum(float(p.detach().double().sum()) for p in model.parameters()))
    return {"metrics": averaged, "local": local, "scales": scales, "checksums": checksums,
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def step_rank(spec: str, out: str, device: str, backend: str):
    mesh = init_distributed(device, backend)
    try:
        torch.save(run_step(spec, mesh), Path(out) / f"rank{mesh.rank}.pt")
    finally:
        shutdown(mesh)


def loader_rank(spec: str, out: str):
    from salience_detr_torch.data.coco import CocoDetection
    from salience_detr_torch.data.loader import TrainLoader
    from salience_detr_torch.data.transforms import build_preset, simple_copy_paste

    mesh = init_distributed("cpu", "gloo")
    try:
        cfg = json.loads(Path(spec).read_text())
        dataset = CocoDetection(cfg["img_dir"], cfg["ann"], transforms=build_preset(cfg["preset"]), train=True,
                                return_masks=cfg["copypaste"])
        loader = TrainLoader(dataset, cfg["batch"], canvas_hw=tuple(cfg["canvas"]), max_gt=cfg["max_gt"],
                             seed=cfg["seed"], num_workers=cfg["num_workers"],
                             batch_transform=simple_copy_paste if cfg["copypaste"] else None, rank=mesh.rank,
                             world=mesh.world, accumulate_steps=cfg["accumulate"], exchange=mesh.loader_exchange)
        arrays = {}
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            before, seconds = loader.samples, loader.transform_s
            batches = iter(loader)
            got = []
            for batch in batches:
                got.append(batch)
                if epoch == 0 and len(got) == cfg.get("stop_after"):
                    break
            batches.close()
            arrays[f"e{epoch}_samples"] = np.asarray(loader.samples - before)
            arrays[f"e{epoch}_transform_s"] = np.asarray(loader.transform_s - seconds)
            arrays[f"e{epoch}_batches"] = np.asarray(len(got))
            arrays.update({f"e{epoch}_{i}_{k}": v for i, b in enumerate(got) for k, v in b.items()})
        np.savez(Path(out) / f"rank{mesh.rank}.npz", **arrays)
    finally:
        shutdown(mesh)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("bn", "step", "loader"))
    p.add_argument("--inputs", help="bn: the .npz of x, dy and the layer's tensors")
    p.add_argument("--spec", help="step: the directory of the run's config, state, batches and draws; "
                                  "loader: the split and loader settings (.json)")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="cuda (each rank on its LOCAL_RANK card) or cpu")
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--threads", type=int, default=2, help="torch intra-op threads of each rank")
    p.add_argument("--deterministic", action="store_true",
                   help="--use-deterministic-algorithms' numerics (the ordered MSDA backward)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ddp_check: device cuda requested but torch.cuda.is_available() is False "
                           "(pass --device cpu to run the ranks on the CPU)")
    torch.set_num_threads(args.threads)
    configure_numerics(args.deterministic, exact_float32=True)  # held against one process
    if args.mode == "bn":
        bn_rank(args.inputs, args.out, args.device, args.backend)
    elif args.mode == "loader":
        loader_rank(args.spec, args.out)
    else:
        step_rank(args.spec, args.out, args.device, args.backend)


if __name__ == "__main__":
    main()
