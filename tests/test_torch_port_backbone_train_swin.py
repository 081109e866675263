"""One train step of the tiny Swin detector (stochastic depth 0) against
``jax.value_and_grad`` of the JAX loss: losses, every layer's assignments
and every trainable parameter's gradient (the checks of
tests/test_torch_port_backbone_models.py)."""

from tests.test_torch_port_backbone_models import check_train_step
from tests.test_torch_port_backbones import tiny_archs  # noqa: F401  (fixture)
from tests.torch_port_common import two_torch_threads  # noqa: F401  (autouse fixture)


def test_tiny_swin_train_step(tiny_archs):  # noqa: F811
    check_train_step("swin_tiny")
