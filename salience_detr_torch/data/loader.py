"""Train and eval batches and the device prefetcher (port of
salience_detr_tpu/data/loader.py).

``TrainLoader`` is the JAX ``DetectionLoader`` in training: the order
shuffled by ``random.Random(seed + epoch)``, each sample augmented with its
own ``random.Random`` drawn from (seed, epoch, index), samples grouped by
orientation onto a fixed canvas (landscape 800x1344, portrait 1344x800 by
default) and packed by :func:`pack_batch` with targets padded to ``max_gt``;
``drop_last`` drops the partial pools, else they are topped up with
duplicates.  Its batches equal the JAX loader's array for array.

``DetectionLoader`` (eval) decodes the dataset's samples in dataset order on
a few threads and groups them by orientation (landscape w >= h, portrait),
as the JAX loader's canvas buckets do: a batch is yielded when its
orientation's pool holds ``batch_size`` samples, and the partial pools
follow at the end, landscape first.  Every image is evaluated once: the
port's shapes need not be static, so a last partial batch is not topped up
with duplicates.  Batches carry the decoded uint8 images; the resize to the
eval geometry happens on the device (``inference.preprocess``).

``DevicePrefetcher`` prepares the next batches on the device while the
consumer runs the current one, through the converter it is given
(``to_device`` with the model config for eval batches, ``train_to_device``
for train batches).  On CUDA a background thread copies
each batch from pinned host memory on a side stream, which also runs the
resize or cast, padding and normalization, and records an event; the
consumer's stream waits for that event.  A failure in the thread is raised
in the consumer.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from salience_detr_torch.data.transforms import resize
from salience_detr_torch.inference import preprocess
from salience_detr_torch.models.bricks.criterion import Targets
from salience_detr_torch.models.detectors.salience_detr import normalize_images
from salience_detr_torch.models.factory import SalienceDETRConfig


def pack_batch(samples: Sequence[dict], canvas_hw: Tuple[int, int], max_gt: int) -> Dict[str, np.ndarray]:
    """Pad samples onto a fixed canvas with targets padded to ``max_gt`` (the
    first ``max_gt`` boxes kept), boxes as normalized cxcywh on each image's
    valid area."""
    B = len(samples)
    H, W = canvas_hw
    images = np.zeros((B, H, W, 3), np.uint8)
    image_sizes = np.zeros((B, 2), np.int32)
    orig_sizes = np.zeros((B, 2), np.int32)
    boxes = np.zeros((B, max_gt, 4), np.float32)
    labels = np.zeros((B, max_gt), np.int32)
    valid = np.zeros((B, max_gt), bool)
    image_ids = np.zeros((B,), np.int64)

    for i, s in enumerate(samples):
        img = s["image"]
        h, w = img.shape[:2]
        if h > H or w > W:
            raise ValueError(f"image {h}x{w} exceeds canvas {H}x{W}")
        images[i, :h, :w] = img
        image_sizes[i] = (h, w)
        orig_sizes[i] = s.get("orig_size", (h, w))
        image_ids[i] = s.get("image_id", i)
        b = np.asarray(s["boxes"], np.float32)[:max_gt]
        n = len(b)
        if n:
            degenerate = (b[:, 2:] <= b[:, :2]).any(axis=1)
            if degenerate.any():
                bad = b[int(np.argmax(degenerate))].tolist()
                raise ValueError(
                    "All bounding boxes should have positive height and "
                    f"width. Found invalid box {bad} for sample index {i} "
                    f"(image_id={s.get('image_id', i)})."
                )
            cx = (b[:, 0] + b[:, 2]) / 2 / w
            cy = (b[:, 1] + b[:, 3]) / 2 / h
            bw = (b[:, 2] - b[:, 0]) / w
            bh = (b[:, 3] - b[:, 1]) / h
            boxes[i, :n] = np.stack([cx, cy, bw, bh], -1)
            labels[i, :n] = np.asarray(s["labels"], np.int64)[:max_gt]
            valid[i, :n] = True

    return {
        "images": images,
        "image_sizes": image_sizes,
        "orig_sizes": orig_sizes,
        "boxes": boxes,
        "labels": labels,
        "gt_valid": valid,
        "image_ids": image_ids,
    }


def fit_to_canvas(sample: dict, canvas_hw: Tuple[int, int]) -> dict:
    """Shortest-side resize into the canvas (never past it)."""
    h, w = sample["image"].shape[:2]
    H, W = canvas_hw
    r = min(H / h, W / w)
    nh, nw = int(h * r), int(w * r)
    return resize(sample, (max(nh, 1), max(nw, 1)))


def _one_intra_op_thread():
    torch.set_num_threads(1)  # per thread: the workers' resizes do not share a pool


class TrainLoader:
    """Iterable over fixed-shape train batches with orientation bucketing.

    ``batch_transform(samples, rng) -> samples`` runs on each pooled batch
    before packing, with an rng drawn from (seed, epoch, batch index).
    ``transform_s`` and ``samples`` accumulate the seconds the workers spent
    loading and augmenting samples and how many they prepared."""

    def __init__(self, dataset, batch_size: int, canvas_hw: Tuple[int, int] = (800, 1344),
                 max_gt: int = 100, shuffle: bool = True, seed: int = 0, num_workers: int = 8,
                 drop_last: bool = True, batch_transform: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.canvas_land = (min(canvas_hw), max(canvas_hw))
        self.canvas_port = (max(canvas_hw), min(canvas_hw))
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.batch_transform = batch_transform
        self.transform_s = 0.0
        self.samples = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _canvas_for(self, sample) -> Tuple[int, int]:
        h, w = sample["image"].shape[:2]
        return self.canvas_land if w >= h else self.canvas_port

    def _prepare(self, idx: int) -> Tuple[dict, float]:
        t0 = time.perf_counter()
        rng = random.Random((self.seed * 1_000_003 + self.epoch) * 1_000_003 + idx)
        s = self.dataset.get_with_rng(idx, rng)
        canvas = self._canvas_for(s)
        h, w = s["image"].shape[:2]
        if h > canvas[0] or w > canvas[1]:
            s = fit_to_canvas(s, canvas)
        return s, time.perf_counter() - t0

    def _pack(self, pool, canvas, batch_idx: int):
        if self.batch_transform is not None:
            rng = random.Random((self.seed * 7_368_787 + self.epoch) * 7_368_787 + batch_idx)
            pool = self.batch_transform(list(pool), rng)
        return pack_batch(pool, canvas, self.max_gt)

    def _samples(self, order: List[int]) -> Iterator[dict]:
        """The samples of ``order``, in order, at most 2 * num_workers in flight."""
        def take(future) -> dict:
            s, spent = future.result()
            self.transform_s += spent
            self.samples += 1
            return s

        with ThreadPoolExecutor(self.num_workers, initializer=_one_intra_op_thread) as ex:
            pending = deque()
            for idx in order:
                pending.append(ex.submit(self._prepare, idx))
                if len(pending) >= 2 * self.num_workers:
                    yield take(pending.popleft())
            while pending:
                yield take(pending.popleft())

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        pools: Dict[Tuple[int, int], List[dict]] = {self.canvas_land: [], self.canvas_port: []}
        batch_idx = 0
        for s in self._samples(order):
            canvas = self._canvas_for(s)
            pool = pools[canvas]
            pool.append(s)
            if len(pool) == self.batch_size:
                yield self._pack(pool, canvas, batch_idx)
                batch_idx += 1
                pool.clear()
        if not self.drop_last:
            for canvas, pool in pools.items():
                if pool:
                    while len(pool) < self.batch_size:  # duplicates keep the batch size
                        pool.append(pool[-1])
                    yield self._pack(pool, canvas, batch_idx)
                    batch_idx += 1


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


def train_to_device(batch: Dict, device: torch.device) -> Dict:
    """A ``pack_batch`` batch -> {"images" (B, 3, H, W) normalized,
    "image_sizes" (B, 2), "targets" (``Targets`` whose ``counts`` are the
    per-image gt counts, read on the host), "image_ids"} on ``device``; on
    CUDA the arrays go through pinned host memory with asynchronous copies on
    the current stream."""
    cuda = device.type == "cuda"

    def put(x: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(x))
        return x.pin_memory().to(device, non_blocking=True) if cuda else x.to(device)

    images = put(batch["images"]).permute(0, 3, 1, 2).contiguous()  # NCHW as the eval and synthetic batches
    counts = tuple(int(n) for n in batch["gt_valid"].sum(1))
    targets = Targets(put(batch["labels"]).long(), put(batch["boxes"]), put(batch["gt_valid"]), counts)
    return {"images": normalize_images(images.float() / 255.0), "image_sizes": put(batch["image_sizes"]).long(),
            "targets": targets, "image_ids": batch["image_ids"]}


class _Failed:
    def __init__(self, error: Exception):
        self.error = error


_END = object()


class DevicePrefetcher:
    """Iterable over ``convert(batch, device=device)`` of the batches of
    ``loader``, up to ``depth`` batches ahead of the consumer; ``convert`` is
    ``functools.partial(to_device, cfg=cfg)`` for eval batches or
    ``train_to_device`` for train batches."""

    def __init__(self, loader, convert: Callable[..., Dict], device, depth: int = 2):
        self.loader = loader
        self.convert = convert
        self.device = torch.device(device)
        self.depth = depth
        self.waits: List[float] = []  # the consumer's seconds blocked on each next batch

    def _to_device(self, batch: Dict) -> Dict:
        return self.convert(batch, device=self.device)

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
                            out = self._to_device(batch)
                            ready = torch.cuda.Event()
                            ready.record(side)
                    else:
                        out, ready = self._to_device(batch), None
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
                t0 = time.perf_counter()
                item = q.get()
                self.waits.append(time.perf_counter() - t0)
                if item is _END:
                    return
                if isinstance(item, _Failed):
                    raise item.error
                out, ready = item
                if ready is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(ready)
                    for v in out.values():
                        for x in (v if isinstance(v, Targets) else (v,)):
                            if isinstance(x, torch.Tensor):
                                x.record_stream(stream)
                yield out
        finally:
            stop.set()
            thread.join(timeout=60)
