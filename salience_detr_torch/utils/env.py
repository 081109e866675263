"""Environment report, numerics, seeding and preemption handling (port of
salience_detr_tpu/utils/env.py): ``collect_env_info`` reports Python, torch,
CUDA and the card's name and power limit; ``configure_numerics`` is the one
place the train and eval CLIs set how the card computes; ``seed_everything``
seeds Python's, numpy's and torch's global generators; ``GracefulShutdown`` turns SIGTERM and
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


def configure_numerics(deterministic: bool = False, exact_float32: bool = False) -> None:
    """The numerics of this process, shared by the train and eval CLIs and
    the serving ``Predictor`` (and the checks that drive them):

    * no cuDNN attention behind ``F.scaled_dot_product_attention``: on the
      H100 PyTorch picks it for the decoder's self-attention, and it gave
      other bits in the first process on a fresh machine than in every
      later one (the eval's results then differed between processes); the
      flash and memory-efficient kernels it falls back to compute a forward
      the same way in every process, at no measured cost to a bf16 train
      step or eval forward (PERF.md);
    * cuDNN's algorithms from its heuristics, never from timing.

    TF32 stays as PyTorch sets it (cuDNN's float32 convolutions in TF32,
    cuBLAS's float32 matmuls not), which repeats from process to process;
    ``exact_float32`` turns it off in both, as the JAX package computes
    float32 and the kernels' plain versions do: the setting of the checks
    that hold the card against the CPU or against another process (it makes
    a float32 train step about 1.4 times as long, PERF.md).

    ``deterministic`` (the train CLI's ``--use-deterministic-algorithms``)
    also makes every op of a train step repeatable:
    ``torch.use_deterministic_algorithms`` (warning, not raising, on an op
    without a deterministic implementation), cuBLAS's fixed workspace
    (``CUBLAS_WORKSPACE_CONFIG``, read when cuBLAS starts), and, where the
    library's kernels add in no fixed order even then, the port's ordered
    formulations: the MSDA backward's ordered design
    (``ops.deform_attn.backward_design``) and SDPA's math formulation in the
    dense attention (``models.bricks.attention.MultiheadAttention``).  With it
    the score heads before a discrete selection also compute one image at a
    time (``models.layers.PerImageLinear``), so that a data-parallel rank
    selects the tokens one process selects (ROADMAP C-27)."""
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cuda.enable_cudnn_sdp(False)
    torch.backends.cudnn.benchmark = False
    if exact_float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


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
