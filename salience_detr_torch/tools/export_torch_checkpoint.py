"""Write a checkpoint of the port as a reference-layout ``{"model": state}``
``.pth`` (the twin of the JAX tool ``tools/export_torch_checkpoint.py``,
which does it for an orbax checkpoint): the state dict the reference
implementation loads, and that the eval CLI's ``--torch-checkpoint`` takes.

    python -m salience_detr_torch.tools.export_torch_checkpoint --model-config F \
        --checkpoint <output_dir>/checkpoints | FILE.pth --out weights.pth

``--checkpoint`` is a checkpoint directory of the train CLI (its newest
epoch) or a ``.pth`` file (a train checkpoint, or a state dict, bare or
under ``"model"``).  The port keeps the reference's key names, so the
reference layout is the state dict's tensors that the converter's rules
name (``weights.converter_rules``), as float32, at the shapes of the same
config in the checkpoint-exact per-head sampling (``exact_sampling``).  A
tensor of the checkpoint with no such slot is named in a warning and left
out, as the JAX tool reports its skipped tensors: the hybrid configs'
head-shared encoder sampling offsets (G = 1, a (32, 256) Linear where the
reference's is (256, 256)) have none.  Runs on the CPU; imports torch and
the port only.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import torch

from salience_detr_torch.inference import load_config
from salience_detr_torch.models.factory import SalienceDETRConfig, build_salience_detr, exact_sampling
from salience_detr_torch.utils.checkpoint import CheckpointManager, load_torch_weights
from salience_detr_torch.utils.logging_utils import setup_logger
from salience_detr_torch.weights import converter_rules


def reference_slots(cfg: SalienceDETRConfig) -> Dict[str, Tuple[int, ...]]:
    """{key: shape} of the reference layout of ``cfg``: the rules' keys, at
    the shapes of its exact-sampling model (built on the meta device)."""
    exact = exact_sampling(cfg)
    with torch.device("meta"):
        model, _ = build_salience_detr(exact, torch.device("meta"))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return {src: shapes[src] for src, _, _ in converter_rules(exact)}


def reference_state(state: Dict[str, torch.Tensor], cfg: SalienceDETRConfig
                    ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(the reference-layout state dict of ``state``, float32 and
    contiguous; the keys of the reference layout that ``state`` cannot fill:
    absent, or of another shape)."""
    out, skipped = {}, []
    for key, shape in reference_slots(cfg).items():
        t = state.get(key)
        if t is None or tuple(t.shape) != shape:
            skipped.append(key)
            continue
        out[key] = t.detach().to("cpu", torch.float32).contiguous()
    return out, skipped


def restore_state(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of a checkpoint directory's newest epoch, or of
    a ``.pth`` file."""
    if os.path.isdir(path):
        restored = CheckpointManager(path).restore_weights()
        if restored is None:
            raise SystemExit(f"no checkpoint found under {path}")
        return restored["model"]
    return load_torch_weights(path)


def main(argv: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model-config", required=True)
    p.add_argument("--checkpoint", required=True, help="a checkpoint directory of the train CLI, or a .pth file")
    p.add_argument("--out", required=True, help=".pth destination")
    args = p.parse_args(argv)

    logger = setup_logger("export_torch")
    cfg = load_config(args.model_config)
    state, skipped = reference_state(restore_state(args.checkpoint), cfg)
    if skipped:
        logger.warning(f"{len(skipped)} tensors have no reference-layout slot (non-exact sampling config?): "
                       f"{skipped}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({"model": state}, args.out)
    logger.info(f"wrote {len(state)} tensors -> {args.out}")
    return state


if __name__ == "__main__":
    main()
