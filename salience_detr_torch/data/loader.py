"""Train and eval batches and the device prefetcher (port of
salience_detr_tpu/data/loader.py).

``TrainLoader`` is the JAX ``DetectionLoader`` in training: the order
shuffled by ``random.Random(seed + epoch)``, each sample augmented with its
own ``random.Random`` drawn from (seed, epoch, index), samples grouped by
orientation onto a fixed canvas (landscape 800x1344, portrait 1344x800 by
default) and packed by :func:`pack_batch` with targets padded to ``max_gt``;
``drop_last`` drops the partial pools, else they are topped up with
duplicates.  Its batches equal the JAX loader's array for array.  In a
data-parallel run (``rank`` of ``world``) it yields the rank's rows of each
global batch (``parallel.mesh.shard_rows``, micro-batch by micro-batch), and
the ranks' batches concatenated in that order equal the one-process batch
byte for byte.  A batch's members are known only once every earlier sample is
augmented (the pools are by the augmented orientation).  With an
``exchange`` (``Mesh.loader_exchange``: every rank's object, over a gloo
group of the loader's own) rank r prepares the positions i = r (mod W) of
the epoch's order and, chunk by chunk, the ranks exchange each prepared
sample's summary (its orientation and its instance count), so that every
rank knows every batch's members.  A rank then prepares again those of its
rows, and of the samples its rows paste from, that another rank prepared
(a sample's augmentation draws from (seed, epoch, index), so it comes out
byte-equal): about 2/W of the one-process work a rank instead of all of
it.  Without an exchange every rank prepares every sample.  Copy-paste
(``simple_copy_paste``) rolls the global batch: every rank draws every
pair's selection in order (from the summaries where it holds no sample) and
composites only its rows' pairs, and packing and the copies to the card are
the rank's rows alone.

``DetectionLoader`` (eval) decodes the dataset's samples in dataset order on
a few threads and groups them by orientation (landscape w >= h, portrait),
as the JAX loader's canvas buckets do: a batch is yielded when its
orientation's pool holds ``batch_size`` samples, and the partial pools
follow at the end, landscape first.  Every image is evaluated once: the
port's shapes need not be static, so a last partial batch is not topped up
with duplicates.  In a data-parallel run rank r of W takes the batches
b = r, r + W, ... of that sequence, which it plans from the annotations'
image sizes and loads alone; an image whose decoded orientation differs from
its annotation's raises.  Batches carry the decoded uint8 images; the resize to the
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

import itertools
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
from salience_detr_torch.parallel.mesh import shard_rows


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


def sample_summary(sample: dict, landscape: bool) -> Tuple[bool, Optional[int]]:
    """What the ranks exchange about a prepared sample: its canvas's
    orientation and its instance count (None without masks), all that the
    pools and copy-paste's draws read of a sample another rank holds."""
    return landscape, len(sample["masks"]) if "masks" in sample else None


def stand_in(summary: Tuple[bool, Optional[int]]) -> dict:
    """A batch member this rank neither packs nor pastes from: what the batch
    transform's draws read of it (an empty mask stack of its instance
    count)."""
    n = summary[1]
    return {} if n is None else {"masks": np.zeros((n, 0, 0), bool)}


class TrainLoader:
    """Iterable over fixed-shape train batches with orientation bucketing.

    ``batch_transform(samples, rng) -> samples`` runs on each pooled batch
    before packing, with an rng drawn from (seed, epoch, batch index); in a
    data-parallel run it is called with ``rows=`` the rank's rows and
    returns those rows' samples, and its ``partners(rows, n)`` names the
    other members it reads whole (a transform without it reads them all).
    ``batch_size`` is the global batch.  ``exchange(obj) -> [every rank's
    obj]`` shares the preparation between the ranks (module docstring).
    ``transform_s`` and ``samples`` accumulate the seconds this rank's
    workers spent loading and augmenting samples and how many they
    prepared."""

    def __init__(self, dataset, batch_size: int, canvas_hw: Tuple[int, int] = (800, 1344),
                 max_gt: int = 100, shuffle: bool = True, seed: int = 0, num_workers: int = 8,
                 drop_last: bool = True, batch_transform: Optional[Callable] = None,
                 rank: int = 0, world: int = 1, accumulate_steps: int = 1,
                 exchange: Optional[Callable[[object], List[object]]] = None):
        self.rows = shard_rows(batch_size, rank, world, accumulate_steps) if world > 1 else None
        self.rank, self.world = rank, world
        self.exchange = exchange if world > 1 else None
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

    def _take(self, future) -> dict:
        """A prepared sample, its seconds and count added in the consuming
        thread."""
        s, spent = future.result()
        self.transform_s += spent
        self.samples += 1
        return s

    def _needed(self, n: int) -> List[int]:
        """The members of a batch of ``n`` this rank reads whole: its rows and
        the members its rows' transform reads."""
        if self.rows is None or (self.batch_transform is not None
                                 and not hasattr(self.batch_transform, "partners")):
            return list(range(n))
        extra = self.batch_transform.partners(self.rows, n) if self.batch_transform is not None else []
        return sorted(set(self.rows) | set(extra))

    def _pack(self, pool: List[int], canvas, batch_idx: int, order: List[int], local: Dict[int, dict],
              summaries: List, ex: ThreadPoolExecutor):
        """The batch of the positions ``pool``: the members this rank reads
        whole from ``local`` or prepared again here, stand-ins for the rest."""
        needed = self._needed(len(pool))
        again = {pool[j]: ex.submit(self._prepare, order[pool[j]]) for j in needed if pool[j] not in local}
        for pos, future in again.items():
            local[pos] = self._take(future)
        samples = [stand_in(summaries[pos]) for pos in pool]
        for j in needed:
            samples[j] = local[pool[j]]
        for pos in pool:
            local.pop(pos, None)
        if self.batch_transform is not None:
            rng = random.Random((self.seed * 7_368_787 + self.epoch) * 7_368_787 + batch_idx)
            if self.rows is None:
                samples = self.batch_transform(samples, rng)
            else:
                samples = self.batch_transform(samples, rng, rows=self.rows)
        elif self.rows is not None:
            samples = [samples[i] for i in self.rows]
        return pack_batch(samples, canvas, self.max_gt)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        n = len(order)
        stride, first = (self.world, self.rank) if self.exchange is not None else (1, 0)
        window = 2 * self.num_workers  # this rank's samples in flight
        chunk = window * stride  # positions between two exchanges
        summaries: List = [None] * n
        local: Dict[int, dict] = {}  # position -> a sample this rank prepared
        pools: Dict[Tuple[int, int], List[int]] = {self.canvas_land: [], self.canvas_port: []}
        batch_idx = 0
        with ThreadPoolExecutor(self.num_workers, initializer=_one_intra_op_thread) as ex:
            own = iter(range(first, n, stride))
            pending = deque()

            def submit(count):
                for pos in itertools.islice(own, count):
                    pending.append((pos, ex.submit(self._prepare, order[pos])))

            submit(window)
            for start in range(0, n, chunk):
                mine = []
                while pending and pending[0][0] < start + chunk:
                    pos, future = pending.popleft()
                    local[pos] = self._take(future)
                    mine.append((pos, sample_summary(local[pos], self._canvas_for(local[pos]) == self.canvas_land)))
                    submit(1)
                if self.exchange is None:
                    parts = [(mine, False)]
                else:
                    parts = self.exchange((mine, False))
                    if any(closing for _, closing in parts):
                        return  # a rank's consumer stopped: none needs a batch of this chunk
                for part, _ in parts:
                    for pos, s in part:
                        summaries[pos] = s
                for pos in range(start, min(n, start + chunk)):
                    canvas = self.canvas_land if summaries[pos][0] else self.canvas_port
                    pool = pools[canvas]
                    pool.append(pos)
                    if len(pool) == self.batch_size:
                        batch = self._pack(pool, canvas, batch_idx, order, local, summaries, ex)
                        batch_idx += 1
                        pool.clear()
                        try:
                            yield batch
                        except GeneratorExit:
                            # the consumer stopped (a dry run, a preemption): every rank stops at
                            # the same step, and one exchange more tells any rank still
                            # preparing that none needs another batch
                            if self.exchange is not None and start + chunk < n:
                                self.exchange(([], True))
                            raise
            if not self.drop_last:
                for canvas, pool in pools.items():
                    if pool:
                        while len(pool) < self.batch_size:  # duplicates keep the batch size
                            pool.append(pool[-1])
                        yield self._pack(pool, canvas, batch_idx, order, local, summaries, ex)
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
    """Iterable over eval batches with orientation bucketing, no shuffle; in
    a data-parallel run (``rank`` of ``world``) the rank's batches of the
    one-process sequence."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, rank: int = 0, world: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.rank, self.world = rank, world

    def _load(self, indices: Sequence[int]) -> Iterator[dict]:
        """The samples of ``indices``, in order, at most 2 * num_workers in flight."""
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending = deque()
            for idx in indices:
                pending.append(ex.submit(self.dataset.__getitem__, idx))
                if len(pending) >= 2 * self.num_workers:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    def _samples(self) -> Iterator[dict]:
        """The dataset's samples in order."""
        return self._load(range(len(self.dataset)))

    def plan(self) -> List[List[int]]:
        """The one-process batches as dataset indices, from the annotations'
        image sizes (``height``, ``width``)."""
        info = self.dataset.coco.imgs
        pools: Dict[bool, List[int]] = {True: [], False: []}
        batches = []
        for idx, img_id in enumerate(self.dataset.ids):
            pool = pools[info[img_id]["width"] >= info[img_id]["height"]]
            pool.append(idx)
            if len(pool) == self.batch_size:
                batches.append(list(pool))
                pool.clear()
        return batches + [pool for pool in pools.values() if pool]

    def __iter__(self) -> Iterator[Dict]:
        if self.world > 1:
            yield from self._sharded()
            return
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

    def _sharded(self) -> Iterator[Dict]:
        info, ids = self.dataset.coco.imgs, self.dataset.ids
        mine = self.plan()[self.rank::self.world]
        samples = self._load([i for b in mine for i in b])
        for batch in mine:
            pool = [next(samples) for _ in batch]
            want = info[ids[batch[0]]]["width"] >= info[ids[batch[0]]]["height"]
            bad = [int(s["image_id"]) for s in pool if (s["image"].shape[1] >= s["image"].shape[0]) != want]
            if bad:
                raise ValueError(f"eval images {bad}: the decoded orientation differs from the annotation's "
                                 "height and width")
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
            batches = iter(self.loader)
            try:
                for batch in batches:
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
                close = getattr(batches, "close", None)
                try:
                    if close is not None:  # a generator's clean-up (the train loader's last exchange)
                        close()
                except Exception as e:
                    end = end if isinstance(end, _Failed) else _Failed(e)
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
