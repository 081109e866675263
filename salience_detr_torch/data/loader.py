"""Eval batches and the device prefetcher (port of the eval half of
salience_detr_tpu/data/loader.py).

``DetectionLoader`` decodes the dataset's samples in dataset order on a few
threads and groups them by orientation (landscape w >= h, portrait), as the
JAX loader's canvas buckets do: a batch is yielded when its orientation's
pool holds ``batch_size`` samples, and the partial pools follow at the end,
landscape first.  Every image is evaluated once: the port's shapes need not
be static, so a last partial batch is not topped up with duplicates.
Batches carry the decoded uint8 images; the resize to the eval geometry
happens on the device (``inference.preprocess``).

``DevicePrefetcher`` prepares the next batches on the device while the
consumer runs the current one.  On CUDA a background thread copies each
image from pinned host memory on a side stream, which also runs the resize,
padding and normalization, and records an event; the consumer's stream
waits for that event.  A failure in the thread is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np
import torch

from salience_detr_torch.inference import preprocess
from salience_detr_torch.models.factory import SalienceDETRConfig


def collate(samples: List[dict]) -> Dict:
    """Samples of one orientation -> {"images": [uint8 HWC arrays],
    "image_ids": (B,) int64, "orig_sizes": (B, 2) int32}."""
    return {
        "images": [s["image"] for s in samples],
        "image_ids": np.asarray([s["image_id"] for s in samples], np.int64),
        "orig_sizes": np.stack([s["orig_size"] for s in samples]),
    }


class DetectionLoader:
    """Iterable over eval batches with orientation bucketing, no shuffle."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers

    def _samples(self) -> Iterator[dict]:
        """The dataset's samples in order, at most 2 * num_workers in flight."""
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending = deque()
            for idx in range(len(self.dataset)):
                pending.append(ex.submit(self.dataset.__getitem__, idx))
                if len(pending) >= 2 * self.num_workers:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    def __iter__(self) -> Iterator[Dict]:
        pools: Dict[bool, List[dict]] = {True: [], False: []}  # landscape, portrait
        for s in self._samples():
            h, w = s["image"].shape[:2]
            pool = pools[w >= h]
            pool.append(s)
            if len(pool) == self.batch_size:
                yield collate(pool)
                pool.clear()
        for pool in pools.values():
            if pool:
                yield collate(pool)


def to_device(batch: Dict, cfg: SalienceDETRConfig, device: torch.device) -> Dict:
    """A loader batch -> {"images" (B, 3, H, W) normalized, "image_sizes",
    "orig_sizes" (B, 2), "image_ids"} on ``device``; on CUDA the images go
    through pinned host memory with asynchronous copies on the current
    stream."""
    images = [torch.from_numpy(np.ascontiguousarray(img)) for img in batch["images"]]
    if device.type == "cuda":
        images = [x.pin_memory().to(device, non_blocking=True) for x in images]
    images, image_sizes, orig_sizes = preprocess(images, cfg, device)
    return {"images": images, "image_sizes": image_sizes, "orig_sizes": orig_sizes,
            "image_ids": batch["image_ids"]}


class _Failed:
    def __init__(self, error: Exception):
        self.error = error


_END = object()


class DevicePrefetcher:
    """Iterable over device batches (``to_device``) of ``loader``, up to
    ``depth`` batches ahead of the consumer."""

    def __init__(self, loader, cfg: SalienceDETRConfig, device, depth: int = 2):
        self.loader = loader
        self.cfg = cfg
        self.device = torch.device(device)
        self.depth = depth

    def __iter__(self) -> Iterator[Dict]:
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            end = _END
            try:
                for batch in self.loader:
                    if cuda:
                        with torch.cuda.device(self.device), torch.cuda.stream(side):
                            out = to_device(batch, self.cfg, self.device)
                            ready = torch.cuda.Event()
                            ready.record(side)
                    else:
                        out, ready = to_device(batch, self.cfg, self.device), None
                    if not offer((out, ready)):
                        return
            except Exception as e:  # raised again in the consumer
                end = _Failed(e)
            finally:
                offer(end)

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _Failed):
                    raise item.error
                out, ready = item
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    for v in out.values():
                        if isinstance(v, torch.Tensor):
                            v.record_stream(stream)
                yield out
        finally:
            stop.set()
            thread.join(timeout=60)
