"""Port grid NMS vs the JAX package's grid_nms_topk: exactly equal, on random
candidate sets and on adversarial conflict chains, and against the naive
sequential greedy spec of tests/test_nms.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.ops.nms import grid_nms_topk as jax_grid_nms
from salience_detr_torch import native
from salience_detr_torch.ops.nms import grid_nms_topk, grid_nms_topk_plain
from tests.test_nms import SHAPES, TOTAL, naive_greedy_grid_nms


def jax_batched(topk, num_out):
    return np.stack([np.asarray(jax_grid_nms(jnp.asarray(row), SHAPES, num_out)) for row in topk])


def chains():
    """Candidate orders that make long suppression chains: a whole level in
    raster order, a snake through level 0, every level interleaved, and a
    clump whose rank order runs against the raster order."""
    level0 = np.arange(SHAPES[0][0] * SHAPES[0][1])
    snake = np.concatenate(
        [row if r % 2 == 0 else row[::-1] for r, row in enumerate(level0.reshape(SHAPES[0]))]
    )
    # each level walked in raster order, the levels advancing together
    interleaved = np.argsort(
        np.concatenate([np.arange(h * w) / (h * w) for h, w in SHAPES]), kind="stable"
    )
    return {
        "raster": level0,
        "snake": snake,
        "all_tokens": np.arange(TOTAL),
        "reverse_clump": np.arange(60)[::-1],
        "interleaved": interleaved,
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jax_random(seed):
    rng = np.random.default_rng(seed)
    topk = np.stack([rng.choice(TOTAL, size=90, replace=False) for _ in range(3)]).astype(np.int32)
    for num_out in (40, 90):
        got = grid_nms_topk_plain(torch.from_numpy(topk), SHAPES, num_out).numpy()
        np.testing.assert_array_equal(got, jax_batched(topk, num_out))


@pytest.mark.parametrize("name", sorted(chains()))
def test_plain_matches_jax_adversarial(name):
    order = chains()[name].astype(np.int32)
    topk = np.stack([order, order[::-1].copy()])
    num_out = min(len(order), 50)
    got = grid_nms_topk_plain(torch.from_numpy(topk), SHAPES, num_out).numpy()
    np.testing.assert_array_equal(got, jax_batched(topk, num_out))
    # survivors are the naive sequential greedy ones, in rank order
    want = naive_greedy_grid_nms(order)
    n = min(len(want), num_out)
    np.testing.assert_array_equal(got[0, :n], want[:n])


def test_cpu_wrapper_runs_plain_version():
    rng = np.random.default_rng(3)
    topk = torch.from_numpy(np.stack([rng.choice(TOTAL, 70, replace=False) for _ in range(2)]).astype(np.int32))
    before = dict(native.LAUNCHES)
    got = grid_nms_topk(topk, SHAPES, 30)
    assert got.dtype == torch.int32
    torch.testing.assert_close(got, grid_nms_topk_plain(topk, SHAPES, 30), rtol=0, atol=0)
    assert native.LAUNCHES == before
