"""Device timing with CUDA events, and the card's name and power limit.

A host clock around an asynchronous launch measures the enqueue; these time
the device: events recorded on the current stream around the calls, read
after a synchronise.  Both warm up with one call first."""

from __future__ import annotations

import subprocess
from typing import Callable, List

import torch


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` calls queued behind a
    sleeping kernel, after one warm-up: the device runs them back to back,
    so a call shorter than the host's enqueue still reads its device time
    (``cuda_ms`` reads the enqueue rate there)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 50_000))  # about 25 us of cycles a call at 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_times(fn: Callable[[], object], iters: int) -> List[float]:
    """Device milliseconds of each of ``iters`` calls, after one warm-up."""
    fn()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
