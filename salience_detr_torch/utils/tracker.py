"""Experiment tracker (the port's copy of salience_detr_tpu/utils/tracker.py):
TensorBoard when ``torch.utils.tensorboard`` imports, else one JSON line per
``log`` call in ``metrics.jsonl``."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class TensorBoardTracker:
    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(os.path.join(output_dir, "tb"))
        except Exception:
            self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")

    def log(self, metrics: Dict[str, float], step: int):
        if self._writer is not None:
            for k, v in metrics.items():
                self._writer.add_scalar(k, v, step)
        else:
            self._jsonl.write(json.dumps({"step": step, "ts": time.time(), **metrics}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
        else:
            self._jsonl.close()
