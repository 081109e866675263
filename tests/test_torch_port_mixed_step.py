"""One tiny train step with the mixed (Align-DETR) criterion, both
packages' ``SetCriterion`` built with ``mixed_match_copies=2`` (as a user of
either package reaches it), against ``jax.value_and_grad`` at the
paired-step tolerance: every weighted loss and the total at rtol 1e-3 /
atol 1e-4, every gradient as tests/test_torch_port_train.py holds the
plain step's."""

import numpy as np

from salience_detr_tpu.models.bricks.criterion import SetCriterion as JaxSetCriterion
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_torch.models.factory import build_criteria
from tests import test_torch_port_train as train_test
from tests.test_torch_port_train import check_step_gradients, run_tiny_train_step
from tests.torch_port_common import jax_variable_shapes, random_variables, tiny_configs
from tests.torch_port_common import two_torch_threads  # noqa: F401

STEP_RTOL, STEP_ATOL = 1e-3, 1e-4


def test_train_step_with_the_mixed_criterion(monkeypatch):
    """One tiny train step, both packages' SetCriterion built with
    mixed_match_copies=2 (as a user of either package reaches it)."""
    jcfg, tcfg = tiny_configs()
    jmodel, _, jsal, _ = build_jax(jcfg)
    variables = random_variables(jax_variable_shapes(jmodel), seed=0)
    jcrit = JaxSetCriterion(num_classes=jcfg.num_classes, cost_class=jcfg.cost_class, cost_bbox=jcfg.cost_bbox,
                            cost_giou=jcfg.cost_giou, alpha=jcfg.focal_alpha, gamma=jcfg.focal_gamma,
                            hybrid=True, mixed_match_copies=2)

    def mixed_criteria(cfg):
        crit, sal = build_criteria(cfg)
        crit.mixed_match_copies = 2
        return crit, sal

    monkeypatch.setattr(train_test, "build_criteria", mixed_criteria)
    r = run_tiny_train_step(jcfg, tcfg, jmodel, jcrit, jsal, variables)
    assert set(r["plosses"]) == set(r["jlosses"])
    for k, v in r["jlosses"].items():
        np.testing.assert_allclose(r["plosses"][k].item(), float(v), rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=k)
    np.testing.assert_allclose(r["ptotal"], r["jtotal"], rtol=STEP_RTOL)
    assert check_step_gradients(r) > 300
