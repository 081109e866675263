"""The data-parallel train step with ``accumulate_steps=2`` against the JAX
step on the global batch (tests/test_torch_port_ddp_step.py at A = 2): the
global batch of 4 splits into micro-batches of images (0, 1) and (2, 3),
each normalised by its own global gt count, rank r holding image r of each
(so rank 0 trains on images 0 and 2, rank 1 on 1 and 3); the gradient
all-reduce runs after the second micro-batch only.  Bounds as in that file.
A global batch that is not divisible by A x W raises before any step."""

import numpy as np
import pytest
import torch

from salience_detr_torch.parallel.mesh import Mesh, shard_rows
from tests.test_torch_port_ddp_step import ATOL, RTOL, check_against_one_process, run_ddp_pair
from tests import test_torch_port_train_pair as pair
from tests.torch_port_common import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def ddp_accum(tmp_path_factory):
    return run_ddp_pair(tmp_path_factory.mktemp("ddp_accum"), accumulate_steps=2, seed=3)


def test_ddp_accumulated_steps_match_the_jax_step(ddp_accum):
    jax_metrics, _, ranks, init, jax_state = ddp_accum
    pair.check_metrics(jax_metrics, ranks[0]["metrics"])
    for name, want in jax_state.items():
        np.testing.assert_allclose(ranks[0]["state"][name].float().numpy(), want.float().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    stats = [n for n in init if ".neck." in n and n.endswith("running_mean")]
    assert stats and all(not torch.equal(ranks[0]["state"][n], init[n]) for n in stats)


def test_ddp_accumulated_steps_match_the_one_process_step(ddp_accum):
    _, one, ranks, init, _ = ddp_accum
    check_against_one_process(one, ranks, init)


def test_rows_of_each_rank_follow_the_micro_batches():
    assert shard_rows(4, 0, 2, 2) == [0, 2] and shard_rows(4, 1, 2, 2) == [1, 3]
    assert shard_rows(8, 1, 2, 2) == [2, 3, 6, 7] and shard_rows(8, 1, 2) == [4, 5, 6, 7]
    assert Mesh(rank=1, world=4).rows(8) == [2, 3]
    with pytest.raises(ValueError, match="global batch 6 is not divisible by --accumulate-steps 2 x world size 2"):
        shard_rows(6, 0, 2, 2)
