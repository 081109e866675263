"""Logging, metric smoothing and progress reporting (the port's copy of
salience_detr_tpu/utils/logging_utils.py): a per-rank logger to stdout and
optionally a file, a windowed median/average meter, and ``MetricLogger``'s
``log_every`` iterator with an ETA."""

from __future__ import annotations

import datetime
import logging
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional


def setup_logger(
    name: str = "salience_detr_torch",
    output: Optional[str] = None,
    rank: int = 0,
    color: bool = True,
) -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, "_configured", False):
        return logger
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    fmt = "[%(asctime)s %(name)s %(levelname)s] %(message)s"
    datefmt = "%m/%d %H:%M:%S"
    if rank == 0:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        if color and sys.stdout.isatty():
            class _ColorFormatter(logging.Formatter):
                COLORS = {"WARNING": "\x1b[33m", "ERROR": "\x1b[31m"}

                def format(self, record):
                    msg = super().format(record)
                    c = self.COLORS.get(record.levelname)
                    return f"{c}{msg}\x1b[0m" if c else msg

            ch.setFormatter(_ColorFormatter(fmt, datefmt=datefmt))
        else:
            ch.setFormatter(logging.Formatter(fmt, datefmt=datefmt))
        logger.addHandler(ch)

    if output is not None:
        os.makedirs(output, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output, f"log.rank{rank}.txt"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt, datefmt=datefmt))
        logger.addHandler(fh)

    if not logger.handlers:  # a rank other than 0 without a file: its errors on stderr
        eh = logging.StreamHandler(stream=sys.stderr)
        eh.setLevel(logging.ERROR)
        eh.setFormatter(logging.Formatter(f"[rank {rank}] " + fmt, datefmt=datefmt))
        logger.addHandler(eh)

    def excepthook(exc_type, exc_value, tb):
        logger.error("Uncaught exception", exc_info=(exc_type, exc_value, tb))

    sys.excepthook = excepthook
    logger._configured = True
    return logger


class SmoothedValue:
    """Windowed median/average meter."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            value=self.value,
        )


class MetricLogger:
    """log_every iterator with ETA."""

    def __init__(self, delimiter: str = "  ", logger: Optional[logging.Logger] = None):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.logger = logger or logging.getLogger("salience_detr_torch")

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "", total: Optional[int] = None):
        i = 0
        if total is None:
            total = len(iterable) if hasattr(iterable, "__len__") else None
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                if total is not None:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    self.logger.info(
                        f"{header} [{i}/{total}] eta: {eta_str} {self} "
                        f"time: {iter_time} data: {data_time}"
                    )
                else:
                    self.logger.info(f"{header} [{i}] {self} time: {iter_time}")
            i += 1
            end = time.time()
        total_s = time.time() - start
        elapsed = str(datetime.timedelta(seconds=int(total_s)))
        self.logger.info(f"{header} Total time: {elapsed} ({total_s:.4f} s, {i} its, median "
                         f"{iter_time.median if i else 0.0:.4f} s / it of the last {min(i, 20)})")
