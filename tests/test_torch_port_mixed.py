"""The criterion options that every shipped config leaves off, in the port
against the JAX package: the mixed (Align-DETR) assignment at C = 1, 2, 4
and 10 (C * M above N included, and an image whose cap leaves no copy) -
the same queries for each gt, the same copy validity, equal totals;
``SetCriterion`` losses with ``mixed_match_copies=2`` and with
``two_stage_binary_cls`` (rtol 1e-3, atol 1e-5); ``SalienceCriterion`` with
``noise_scale=0.1`` fed the JAX draws; ``ia_bce_loss`` and its gradient
against ``jax.vjp`` (the train step with the mixed criterion is
tests/test_torch_port_mixed_step.py).  The C copies of a gt are identical
columns, so which copy takes which query is a tie: per-entry maps are not
compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.bricks.criterion import SalienceCriterion as JaxSalienceCriterion
from salience_detr_tpu.models.bricks.criterion import SetCriterion as JaxSetCriterion
from salience_detr_tpu.models.bricks.criterion import Targets as JaxTargets
from salience_detr_tpu.ops import losses as jax_losses
from salience_detr_tpu.ops.hungarian import batched_mixed_assignment as jax_mixed
from salience_detr_torch.models.bricks.criterion import SalienceCriterion, SetCriterion, Targets
from salience_detr_torch.ops import losses
from salience_detr_torch.ops.hungarian import batched_mixed_assignment, batched_mixed_assignment_plain
from tests.test_torch_port_train import loss_inputs
from tests.torch_port_common import t
from tests.torch_port_common import two_torch_threads  # noqa: F401

def query_sets(match, valid):
    """{(image, gt): sorted queries of its valid copies}."""
    B, C, M = match.shape
    return {(b, g): sorted(int(match[b, c, g]) for c in range(C) if valid[b, c, g])
            for b in range(B) for g in range(M)}


def totals(cost, match, valid):
    return [sum(float(cost[b, match[b, c, g], g]) for c in range(match.shape[1]) for g in range(match.shape[2])
                if valid[b, c, g]) for b in range(cost.shape[0])]


@pytest.mark.parametrize("copies", [1, 2, 4, 10])
def test_mixed_assignment_plain_vs_jax(copies):
    rng = np.random.default_rng(copies)
    B, N, M = 4, 30, 20
    cost = (rng.uniform(-1, 4, (B, N, M))).astype(np.float32)
    valid = np.arange(M)[None] < np.asarray([[8], [3], [0], [16]])  # 16 > N // 2: no copy
    want, want_valid = (np.asarray(a) for a in jax_mixed(jnp.asarray(cost), jnp.asarray(valid), copies))
    got, got_valid = batched_mixed_assignment_plain(t(cost), t(valid), copies)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, copies, M)
    got, got_valid = got.numpy(), got_valid.numpy()
    np.testing.assert_array_equal(got_valid, want_valid)
    assert not got_valid[3].any() and (got[~got_valid] == -1).all()
    assert query_sets(got, got_valid) == query_sets(want, want_valid)
    np.testing.assert_allclose(totals(cost, got, got_valid), totals(cost, want, want_valid), rtol=0, atol=1e-5)
    rows = got_valid.reshape(B, -1).sum(1)
    assert (rows <= N // 2).all() or copies == 1
    if copies == 10:
        assert copies * M > N and rows[1] == 15  # 5 copies of 3 gts
    # the wrapper takes a CPU tensor to the plain version
    wrapped, _ = batched_mixed_assignment(t(cost), t(valid), copies)
    assert query_sets(wrapped.numpy(), got_valid) == query_sets(got, got_valid)


def criterion_inputs():
    outputs, labels, gt, valid, counts, sizes = loss_inputs(seed=21)
    return outputs, labels, gt, valid, counts


@pytest.mark.parametrize("options", [
    dict(mixed_match_copies=2),
    dict(two_stage_binary_cls=True),
    dict(mixed_match_copies=3, two_stage_binary_cls=True),
], ids=["mixed2", "binary_enc", "mixed3_binary_enc"])
def test_set_criterion_options_vs_jax(options):
    outputs, labels, gt, valid, counts = criterion_inputs()
    K = outputs["pred_class"].shape[-1]
    num_boxes = float(sum(counts))
    jcrit = JaxSetCriterion(num_classes=K, hybrid=True, **options)
    want = jcrit(*(jnp.asarray(outputs[k]) for k in ("pred_class", "pred_coord", "enc_class", "enc_coord")),
                 JaxTargets(*map(jnp.asarray, (labels, gt, valid))), jnp.float32(num_boxes))
    crit = SetCriterion(K, hybrid=True, **options)
    targets = Targets(t(labels).long(), t(gt), t(valid), counts)
    got = crit(*(t(outputs[k]) for k in ("pred_class", "pred_coord", "enc_class", "enc_coord")), targets, num_boxes)
    assert set(got) == set(want) and len(got) == 3 * 3
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-3, atol=1e-5, err_msg=k)
    # one assignment call for the stacked sets, its maps over the tiled targets
    matches = crit.match_sets(*(t(outputs[k]) for k in ("pred_class", "pred_coord", "enc_class", "enc_coord")),
                              targets)
    width = labels.shape[1] * options.get("mixed_match_copies", 1)
    assert len(matches) == 3 and all(tuple(m.shape) == (2, width) for m in matches)


def test_mixed_losses_do_not_depend_on_copy_labels():
    """Swapping which copy holds which of a gt's queries leaves every loss
    as it was (the ties the kernel and the plain version may break
    differently)."""
    outputs, labels, gt, valid, counts = criterion_inputs()
    crit = SetCriterion(outputs["pred_class"].shape[-1], mixed_match_copies=2)
    targets = Targets(t(labels).long(), t(gt), t(valid), counts)
    match, tiled = crit.match_mixed(t(outputs["pred_class"][0]), t(outputs["pred_coord"][0]), targets)
    M = labels.shape[1]
    swapped = torch.cat([match[:, M:], match[:, :M]], 1)
    swapped = torch.where(tiled.valid, swapped, match)
    both_valid = tiled.valid[:, :M] & tiled.valid[:, M:]
    swapped = torch.where(torch.cat([both_valid, both_valid], 1), swapped, match)
    a = crit.calculate_loss(t(outputs["pred_class"][0]), t(outputs["pred_coord"][0]), tiled, 4.0, gt_to_query=match)
    b = crit.calculate_loss(t(outputs["pred_class"][0]), t(outputs["pred_coord"][0]), tiled, 4.0,
                            gt_to_query=swapped)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7)


def test_salience_criterion_noise_with_jax_draws():
    outputs, labels, gt, valid, counts, sizes = loss_inputs(seed=22)
    key = jax.random.PRNGKey(3)
    jsal = JaxSalienceCriterion(noise_scale=0.1)
    jtargets = JaxTargets(*map(jnp.asarray, (labels, gt, valid)))
    want = jsal([jnp.asarray(a) for a in outputs["salience"]], jtargets, outputs["feature_strides"],
                jnp.asarray(sizes), rng=key)["loss_salience"]
    draws, k = [], key
    for a in outputs["salience"]:
        k, sub = jax.random.split(k)
        draws.append(t(np.asarray(jax.random.uniform(sub, (a.shape[0], a.shape[1] * a.shape[2])))))
    sal = SalienceCriterion(noise_scale=0.1)
    targets = Targets(t(labels).long(), t(gt), t(valid), counts)
    got = sal([t(a) for a in outputs["salience"]], targets, outputs["feature_strides"], t(sizes),
              uniform=draws)["loss_salience"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-7)
    # without draws the noise is off, as the JAX criterion without a key
    plain = sal([t(a) for a in outputs["salience"]], targets, outputs["feature_strides"], t(sizes))
    jplain = jsal([jnp.asarray(a) for a in outputs["salience"]], jtargets, outputs["feature_strides"],
                  jnp.asarray(sizes))
    np.testing.assert_allclose(plain["loss_salience"].item(), float(jplain["loss_salience"]), rtol=1e-5)
    # a generator draws its own uniform numbers
    drawn = sal([t(a) for a in outputs["salience"]], targets, outputs["feature_strides"], t(sizes),
                generator=torch.Generator().manual_seed(0))["loss_salience"]
    assert np.isfinite(drawn.item()) and drawn.item() != plain["loss_salience"].item()


def test_ia_bce_loss_and_gradient_vs_jax():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(2, 9, 5)) * 3).astype(np.float32)
    targets = (rng.uniform(size=(2, 9, 5)) < 0.2).astype(np.float32)
    score = rng.uniform(size=(2, 9)).astype(np.float32)
    mask = rng.uniform(size=(1, 9, 1)) < 0.7
    cot = np.float32(1.7)

    def jax_fn(x):
        return jax_losses.ia_bce_loss(x, jnp.asarray(targets), jnp.asarray(score), 3.0, mask=jnp.asarray(mask))

    want, vjp = jax.vjp(jax_fn, jnp.asarray(logits))
    (want_grad,) = vjp(jnp.float32(cot))
    x = t(logits).requires_grad_()
    got = losses.ia_bce_loss(x, t(targets), t(score), 3.0, mask=t(mask))
    (got * float(cot)).backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-7)
