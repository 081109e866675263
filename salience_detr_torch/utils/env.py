"""Environment report, seeding and preemption handling (port of
salience_detr_tpu/utils/env.py): ``collect_env_info`` reports Python, torch,
CUDA and the card's name and power limit; ``seed_everything`` seeds Python's,
numpy's and torch's global generators; ``GracefulShutdown`` turns SIGTERM and
SIGINT into a flag the train loop polls, so that a preempted run finishes its
step, writes a checkpoint and exits 0.  In a data-parallel run the flag is
this process's; the train step's all-reduce of each step carries it to every
rank (``parallel.train_step.TrainStep.should_stop``), so a signal to any rank
stops all of them after the same step."""

from __future__ import annotations

import os
import platform
import random
import signal
import subprocess
import sys
from typing import Optional

import numpy as np
import torch


def collect_env_info() -> str:
    lines = [
        f"python:    {sys.version.split()[0]} ({platform.platform()})",
        f"torch:     {torch.__version__}   CUDA: {torch.version.cuda}",
    ]
    if torch.cuda.is_available():
        lines.append(f"devices:   {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
        try:
            from salience_detr_torch.timing import card_line

            lines.append(f"card:      {card_line()}")
        except (OSError, subprocess.CalledProcessError) as e:
            lines.append(f"card:      nvidia-smi unavailable ({e})")
    else:
        lines.append("devices:   no CUDA device")
    for var in ("CUDA_VISIBLE_DEVICES", "TORCH_CUDA_ARCH_LIST"):
        if os.environ.get(var):
            lines.append(f"{var}={os.environ[var]}")
    return "\n".join(lines)


def seed_everything(seed: Optional[int] = None) -> int:
    """Seed Python's, numpy's and torch's generators; returns the seed (drawn
    from the pid and urandom when None)."""
    if seed is None:
        seed = (os.getpid() + int.from_bytes(os.urandom(2), "big")) % (2**31)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed


class GracefulShutdown:
    """Preemption-aware stop flag: SIGTERM/SIGINT handlers that set a flag
    instead of killing the process, so the train loop can finish the step in
    flight, write a checkpoint and exit cleanly.

    Usage::

        with GracefulShutdown() as stop:
            for epoch in ...:
                step, _ = train_one_epoch(..., stop_requested=stop)
                if stop.requested:
                    ckpt.save(...)
                    break
    """

    def __init__(self, signals=None, logger=None):
        self.signals = tuple(signals) if signals else (signal.SIGTERM, signal.SIGINT)
        self.logger = logger
        self.requested = False
        self._previous = {}

    def __call__(self) -> bool:
        return self.requested

    def _handler(self, signum, frame):
        self.requested = True
        msg = f"received signal {signum}: finishing step, then checkpoint + exit"
        if self.logger is not None:
            self.logger.warning(msg)
        else:
            print(msg, file=sys.stderr, flush=True)

    def __enter__(self):
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        return False
