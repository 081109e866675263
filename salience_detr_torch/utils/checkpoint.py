"""Train checkpoints as ``torch.save`` files (port of
salience_detr_tpu/utils/checkpoint.py, which writes orbax checkpoints).

``CheckpointManager`` writes ``<dir>/<epoch>.pth`` and keeps the 5 newest,
with a ``metadata.json`` sidecar (class names, model config path, seed);
``HighestCheckpoint`` keeps the best-AP and best-AP50 snapshots;
``tolerant_update`` merges a state dict into another, skipping tensors whose
name or shape does not match; ``load_torch_weights`` reads a ``.pth`` state
dict, unwrapping a ``"model"`` or ``"state_dict"`` entry.

A train checkpoint holds the model state dict in the upstream layout (the
port's keys, loadable by the JAX package's converter), the optimizer state,
the step, the epoch and whether it was completed, the ``GradScaler`` state
(or None) and the seed from which every epoch's random streams are drawn.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

_EPOCH_FILE = re.compile(r"^(\d+)\.pth$")


def _atomic_save(obj: Any, path: str):
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Epoch checkpoints with retention, and named snapshots."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_EPOCH_FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict, metadata: Optional[Dict] = None):
        _atomic_save(state, os.path.join(self.directory, f"{step}.pth"))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"{old}.pth"))
        if metadata is not None:
            self.write_metadata(metadata)

    def write_metadata(self, metadata: Dict):
        """Run metadata (class vocabulary, model config, seed) beside the
        checkpoints, so that the directory describes itself."""
        with open(os.path.join(self.directory, "metadata.json"), "w") as f:
            json.dump(metadata, f)

    def read_metadata(self) -> Optional[Dict]:
        path = os.path.join(self.directory, "metadata.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore(self, step: Optional[int] = None) -> Optional[Dict]:
        """The checkpoint of ``step`` (the newest by default), or None."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(os.path.join(self.directory, f"{step}.pth"), map_location="cpu", weights_only=True)

    def restore_weights(self, step: Optional[int] = None) -> Optional[Dict]:
        """``{"step", "model"}`` of a checkpoint, for eval and fine-tuning."""
        restored = self.restore(step)
        if restored is None:
            return None
        return {"step": restored.get("step"), "model": restored["model"]}

    def save_named(self, name: str, state: Dict):
        """A snapshot under its own name (best_ap, best_ap50)."""
        _atomic_save(state, os.path.join(self.directory, f"{name}.pth"))

    def restore_named(self, name: str) -> Dict:
        return torch.load(os.path.join(self.directory, f"{name}.pth"), map_location="cpu", weights_only=True)


class HighestCheckpoint:
    """Tracks the best AP and AP50 and snapshots the state on each
    improvement."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager
        self.best_ap = -1.0
        self.best_ap50 = -1.0

    def update(self, state: Dict, ap: float, ap50: float):
        if ap > self.best_ap:
            self.best_ap = ap
            self.manager.save_named("best_ap", state)
        if ap50 > self.best_ap50:
            self.best_ap50 = ap50
            self.manager.save_named("best_ap50", state)


def load_torch_weights(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict as tensors, unwrapping a ``"model"`` or
    ``"state_dict"`` entry."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("model", "state_dict"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(wrapper), dict):
            ckpt = ckpt[wrapper]
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v) for k, v in ckpt.items()}


def tolerant_update(current: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor],
                    logger=None) -> Tuple[Dict[str, torch.Tensor], int, List[tuple]]:
    """``current`` with the tensors of ``updates`` whose name and shape match
    (cast to the current dtype); returns (merged, applied, mismatches), each
    mismatch (name, expected shape or "missing", given shape), the first 50
    logged."""
    out = dict(current)
    mismatches, applied = [], 0
    for name, value in updates.items():
        if name not in current:
            mismatches.append((name, "missing", tuple(value.shape)))
            continue
        if tuple(current[name].shape) != tuple(value.shape):
            mismatches.append((name, tuple(current[name].shape), tuple(value.shape)))
            continue
        out[name] = value.to(current[name].dtype)
        applied += 1
    if logger and mismatches:
        for name, expected, got in mismatches[:50]:
            logger.warning(f"skip weight {name}: expected {expected}, got {got}")
    return out, applied, mismatches
