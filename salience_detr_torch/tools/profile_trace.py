"""Write a device trace of the eval forward or the train step, with the
model's regions named (the twin of the JAX tool ``tools/profile_trace.py``).

    python -m salience_detr_torch.tools.profile_trace [--mode inference|train] [--logdir traces]
        [--batch 4] [--height 800] [--width 1344] [--iters 3] [--model-config F] [--sampling shared_dec0]
        [--device cuda|cpu]
    python -m salience_detr_torch.tools.trace_report --trace traces/trace.json --depth 2

Builds the model of ``--model-config`` (the flagship by default) with the
sampling of ``--sampling`` (``bench.py``'s grammar: ``shared``,
``groups<G>`` or ``exact``, and an optional ``_dec<D>`` for the decoder;
the default ``shared_dec0`` is the shipped hybrid flagship) from seed 0, in
the config's dtype (bf16 autocast on the card), runs one untraced iteration
and then ``--iters`` traced ones under ``torch.profiler`` (host and device
activity), and writes ``<logdir>/trace.json`` (``export_chrome_trace``:
Perfetto opens it) and ``<logdir>/meta.json`` (mode, iterations, shapes,
the card's name and power limit).  ``inference``: the eval forward of
seeded uniform images on the full canvas; ``train``: ``Trainer`` steps on
synthetic batches of ``--batch`` images at the canvas.

While it traces, hooks that this tool installs on every submodule of the
model wrap each call in ``torch.profiler.record_function`` named by its
path relative to the enclosing hooked module (``backbone``, ``layer1``,
``0``, ...); the three whole-module scopes of the JAX package take their
JAX names (``backbone``, ``channel_mapper`` for the ChannelMapper,
``repnet_neck`` for the transformer's neck), and the model names the scopes
inside its forward functions itself (``utils/profiling.py``), so a report's
rows are the JAX report's.  The hooks are removed afterwards, and without a
profiler the model marks nothing.  The train step's criteria (plain
classes) are named ``criterion`` and ``salience_criterion`` the same way;
the optimizer step names itself (``Optimizer.step#AdamW.step``).

What differs from the JAX tool: no HLO dump (the regions are in the trace),
the default ``--logdir`` is ``traces/`` in the checkout, and it runs on the
card unless ``--device cpu`` is given (a CPU trace has host operators only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
from salience_detr_torch.tools.quality import REPO, platform, require_device, sampling_groups

# the JAX package's scopes that are whole modules, by the module's path
SCOPE_MODULES = {"backbone": "backbone", "neck": "channel_mapper", "transformer.neck": "repnet_neck"}


def sampling_cfg(sampling: str):
    """``bench.py``'s sampling grammar -> (sampling_groups,
    decoder_sampling_groups) in the JAX config's terms (0 = one group a
    head, -1 = the decoder follows the encoder)."""
    dec_groups = -1
    if "_dec" in sampling:
        sampling, dec = sampling.split("_dec")
        dec_groups = int(dec)
    if sampling.startswith("groups"):
        groups = int(sampling[len("groups"):])
    elif sampling == "shared":
        groups = 1
    else:
        groups = 0
    return groups, dec_groups


class ModuleRegions:
    """While entered, each call of a submodule of ``model`` runs inside a
    ``record_function`` range named by its path relative to the innermost
    hooked module running (:data:`SCOPE_MODULES` renamed)."""

    def __init__(self, model: torch.nn.Module):
        self.paths = {m: n for n, m in model.named_modules() if n}
        self.running: List[str] = []
        self.ranges: List[record_function] = []
        self.handles = []

    def name(self, path: str) -> str:
        if path in SCOPE_MODULES:
            return SCOPE_MODULES[path]
        outer = next((p for p in reversed(self.running) if path.startswith(p + ".")), None)
        return path[len(outer) + 1:] if outer else path

    def pre(self, module, args):
        path = self.paths[module]
        rf = record_function(self.name(path))
        rf.__enter__()
        self.running.append(path)
        self.ranges.append(rf)

    def post(self, module, args, output):
        self.running.pop()
        self.ranges.pop().__exit__(None, None, None)

    def __enter__(self):
        for m in self.paths:
            self.handles.append(m.register_forward_pre_hook(self.pre))
            self.handles.append(m.register_forward_hook(self.post, always_call=True))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles.clear()


class NamedCalls:
    """While entered, each call of the criteria (plain classes, not modules)
    runs inside a ``record_function`` range of its name; the classes'
    ``__call__`` is restored on exit."""

    def __init__(self, names: Dict[type, str]):
        self.names, self.saved = names, {}

    def __enter__(self):
        for cls, name in self.names.items():
            real = self.saved[cls] = cls.__call__

            def named(obj, *args, _real=real, _name=name, **kwargs):
                with record_function(_name):
                    return _real(obj, *args, **kwargs)

            cls.__call__ = named
        return self

    def __exit__(self, *exc):
        for cls, real in self.saved.items():
            cls.__call__ = real


def criteria_regions() -> NamedCalls:
    from salience_detr_torch.models.bricks.criterion import SalienceCriterion, SetCriterion

    return NamedCalls({SetCriterion: "criterion", SalienceCriterion: "salience_criterion"})


def model_config(path: str, sampling: str):
    groups, dec_groups = sampling_cfg(sampling)
    encoder, decoder = sampling_groups(groups == 0, groups, dec_groups)
    return dataclasses.replace(load_config(path), encoder_sampling_groups=encoder, decoder_sampling_groups=decoder)


def inference_run(cfg, device, batch: int, canvas):
    from salience_detr_torch.models.factory import build_salience_detr
    from salience_detr_torch.parallel.train_step import eval_autocast

    model, _ = build_salience_detr(cfg, device, torch.Generator().manual_seed(0))
    H, W = canvas
    images = torch.from_numpy(np.random.default_rng(0).uniform(-2, 2, (batch, 3, H, W)).astype(np.float32)).to(device)
    sizes = torch.tensor([[H, W]] * batch, device=device)

    def run():
        with torch.no_grad(), eval_autocast(device, cfg.dtype):
            return model(images, sizes)["pred_class"][-1]

    return model, run


def train_run(cfg, device, batch: int, canvas, iters: int):
    from salience_detr_torch.tools.common import synthetic_trainer

    trainer, batches = synthetic_trainer(cfg, device, iters + 1, batch, canvas)
    batches = iter(batches)
    return trainer.model, lambda: trainer.step(next(batches), trainer.generator)


def trace(mode: str, cfg, device: torch.device, batch: int, canvas, iters: int, logdir: Path) -> Dict:
    """Writes ``trace.json`` and ``meta.json`` under ``logdir``; returns the
    meta record (with the traced iterations' host ms)."""
    from salience_detr_torch.utils.env import configure_numerics

    configure_numerics()
    model, run = inference_run(cfg, device, batch, canvas) if mode == "inference" else \
        train_run(cfg, device, batch, canvas, iters)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    run()  # warm-up, untraced
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with ModuleRegions(model), criteria_regions(), profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        sync()
        host_ms = 1e3 * (time.perf_counter() - t0) / iters
    logdir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(logdir / "trace.json"))
    card = None
    if device.type == "cuda":
        from salience_detr_torch.timing import card_line

        card = card_line()
    meta = {"mode": mode, "iters": iters, "batch": batch, "canvas": list(canvas), "dtype": str(cfg.dtype),
            "encoder_sampling_groups": cfg.encoder_sampling_groups,
            "decoder_sampling_groups": cfg.decoder_sampling_groups, "device": platform(device), "card": card,
            "profiled_host_ms_an_iter": host_ms}
    (logdir / "meta.json").write_text(json.dumps(meta, indent=1))
    return meta


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["inference", "train"], default="inference")
    p.add_argument("--logdir", default=str(REPO / "traces"))
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--model-config", default=str(DEFAULT_CONFIG))
    p.add_argument("--sampling", default="shared_dec0",
                   help="shared | groups<G> | exact, with an optional _dec<D> decoder override (bench.py's grammar)")
    p.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)
    device = require_device(args.device)
    meta = trace(args.mode, model_config(args.model_config, args.sampling), device, args.batch,
                 (args.height, args.width), args.iters, Path(args.logdir))
    print(f"trace written to {Path(args.logdir) / 'trace.json'} ({json.dumps(meta)})")
    return meta


if __name__ == "__main__":
    main()
