"""A dry run of each traffic generator on each mix file, at a tiny size:
the same seed gives the same inputs, every seed the same sizes."""

import json

import numpy as np
import torch

from portbench.harness import serve, train
from portbench.harness.common import BENCH
from portbench.tests.tiny import TINY_MODEL


def mixes(kind):
    for path in sorted((BENCH / "traffic").glob("*.json")):
        t = json.loads(path.read_text())
        if t["kind"] == kind:
            yield path.stem, t


def test_serve_mixes():
    for name, t in mixes("serve"):
        small = {**t, "pool": 4, "landscape": 3, "batch": 3,
                 "sizes": {k: [[h // 8, w // 8] for h, w in v] for k, v in t["sizes"].items()}}
        a, b, c = serve.make_pool(small, 12), serve.make_pool(small, 12), serve.make_pool(small, 2**33 + 5)
        assert len(a) == 4 and all(len(call) == 3 for call in a)
        assert all(np.array_equal(x, y) for ca, cb in zip(a, b) for x, y in zip(ca, cb))
        sizes = lambda pool: sorted(x.shape for call in pool for x in call)
        assert sizes(a) == sizes(c)
        for call in a:  # one orientation a call
            assert len({x.shape[1] >= x.shape[0] for x in call}) == 1, name


def test_train_mixes():
    m = {**json.loads((BENCH / "configs" / "sdetr_r50.json").read_text())["model"], **TINY_MODEL}
    for name, t in mixes("train"):
        small = {**t, "canvas": [32, 48]}
        pool, draws = train.make_pool(small, m, 2**31 + 11, torch.device("cpu"))
        again, _ = train.make_pool(small, m, 2**31 + 11, torch.device("cpu"))
        assert len(pool) == len(t["gt_counts"]) == len(draws)
        for (p, r), (q, _), counts in zip(pool, again, t["gt_counts"]):
            assert torch.equal(p["images"], q["images"]) and p["images"] is r["images"]
            assert sorted(p["targets"].counts) == sorted(counts)
            assert torch.equal(p["targets"].valid.sum(1), torch.tensor(p["targets"].counts))
            boxes = p["targets"].boxes[p["targets"].valid]
            assert bool(((boxes[:, :2] - boxes[:, 2:] / 2) >= -1e-6).all()), name
