"""The criterion's batched matching: one cost computation and one assignment
call for all the sets of a step (the decoder layers and the encoder's
proposals) gives, set for set, the assignments and the losses of one
``SetCriterion.match`` per set.  The whole tiny train step against
``jax.value_and_grad`` is in tests/test_torch_port_train.py."""

import numpy as np
import pytest
import torch

from salience_detr_torch import native
from salience_detr_torch.models.bricks.criterion import SetCriterion, Targets

L, B, Q, K, M = 3, 2, 30, 5, 6
COUNTS = (4, 1)


def random_boxes(rng, *shape):
    cxy = rng.uniform(0.2, 0.8, (*shape, 2))
    wh = rng.uniform(0.05, 0.4, (*shape, 2))
    return torch.from_numpy(np.concatenate([cxy, wh], -1).astype(np.float32))


def random_sets(seed, enc_queries=Q, device="cpu"):
    """Decoder outputs (L, B, Q, .), encoder outputs (B, enc_queries, .) and
    padded targets with COUNTS valid gts."""
    rng = np.random.default_rng(seed)
    outputs_class = torch.from_numpy(rng.normal(size=(L, B, Q, K)).astype(np.float32) * 2)
    enc_class = torch.from_numpy(rng.normal(size=(B, enc_queries, K)).astype(np.float32) * 2)
    valid = np.arange(M)[None] < np.asarray(COUNTS)[:, None]
    targets = Targets(torch.from_numpy(rng.integers(0, K, (B, M))), random_boxes(rng, B, M),
                      torch.from_numpy(valid), COUNTS)
    sets = (outputs_class, random_boxes(rng, L, B, Q), enc_class, random_boxes(rng, B, enc_queries))
    return tuple(x.to(device) for x in sets), Targets(*(x.to(device) for x in targets[:3]), COUNTS)


def per_set_matches(crit, sets, targets):
    outputs_class, outputs_coord, enc_class, enc_coord = sets
    return [crit.match(outputs_class[i], outputs_coord[i], targets) for i in range(L)] + [
        crit.match(enc_class, enc_coord, targets)
    ]


@pytest.mark.parametrize("enc_queries", [Q, 20])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_sets_equals_one_match_per_set(seed, enc_queries):
    """Stacked sets (and an encoder set of another query count, matched on
    its own) give each set the assignment of its own call."""
    crit = SetCriterion(K)
    sets, targets = random_sets(seed, enc_queries)
    got = crit.match_sets(*sets, targets)
    want = per_set_matches(crit, sets, targets)
    assert len(got) == L + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32 and tuple(g.shape) == (B, M), i
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=f"set {i}")
        assert bool((g[~targets.valid] == -1).all())


@pytest.mark.parametrize("hybrid", [True, False])
def test_criterion_losses_equal_per_set_losses(hybrid):
    """The losses of the batched call equal those of one ``calculate_loss``
    per set, each matching its own set."""
    crit = SetCriterion(K, hybrid=hybrid)
    sets, targets = random_sets(3)
    outputs_class, outputs_coord, enc_class, enc_coord = sets
    got = crit(*sets, targets, float(sum(COUNTS)))
    want = {}
    for i in range(L):
        suffix = "" if i == L - 1 else f"_{i}"
        layer = crit.calculate_loss(outputs_class[i], outputs_coord[i], targets, float(sum(COUNTS)))
        want.update({k + suffix: v for k, v in layer.items()})
    enc = crit.calculate_loss(enc_class, enc_coord, targets, float(sum(COUNTS)))
    want.update({k + "_enc": v for k, v in enc.items()})
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.gpu
def test_criterion_launches_one_assignment_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    crit = SetCriterion(K)
    sets, targets = random_sets(4, device="cuda")
    before = native.LAUNCHES["hungarian"]
    got = crit.match_sets(*sets, targets)
    torch.cuda.synchronize()
    assert native.LAUNCHES["hungarian"] == before + 1
    cpu_sets, cpu_targets = random_sets(4)
    for g, w in zip(got, crit.match_sets(*cpu_sets, cpu_targets)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
