"""The modules where the flagship's float32 forward first parts from the JAX
package, each alone on identical seeded inputs, held in float32 ulps of
the magnitude of its terms (ROADMAP C-33; ``tests/flagship_parity_walk.py``
walks the whole forward).

* FrozenBatchNorm (the backbone's ``bn1``, the first module whose output
  parts): XLA:CPU contracts ``x * w + b`` into one fused multiply-add and
  rounds its ``rsqrt`` otherwise; the port rounds the product and the sum
  apart, as PyTorch's CPU and CUDA kernels do.
* A 3x3 convolution (``layer1.0.conv2``, the first to part by its order of
  sums: oneDNN against XLA:CPU) and a Linear (the encoder's class head,
  whose maximum over classes ranks the proposals: MKL against XLA:CPU).

A gap is counted in units of the float32 spacing at the sum of the terms'
magnitudes (``|x w| + |bias| + |mean w|``; for a product, the product of
magnitudes), so cancellation in a result does not inflate it.  Each bound
is the largest gap measured over seeds 0-39 at these shapes (4, 5 and 4.5
ulps); the test runs seeds 0-4."""

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from salience_detr_tpu.models.layers import FrozenBatchNorm
from salience_detr_torch.models.layers import FrozenBatchNorm2d
from tests.torch_port_common import two_torch_threads  # noqa: F401 (an autouse fixture)

SEEDS = range(5)


def spacing_units(got, want, terms):
    return np.abs(got.astype(np.float64) - want) / np.spacing(terms.astype(np.float32))


def frozen_bn(rng):
    C = 64
    x = rng.normal(size=(2, 16, 24, C)).astype(np.float32)
    stats = {k: v.astype(np.float32) for k, v in dict(
        scale=rng.uniform(0.8, 1.2, C), bias=0.02 * rng.normal(size=C), mean=0.01 * rng.normal(size=C),
        var=rng.uniform(0.5, 1.5, C)).items()}
    want = np.asarray(jax.jit(lambda v, x: FrozenBatchNorm(C).apply(v, x))({"frozen": stats}, x))
    layer = FrozenBatchNorm2d(C)
    for port_name, jax_name in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                                ("running_var", "var")):
        getattr(layer, port_name).copy_(torch.from_numpy(stats[jax_name]))
    got = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    w = stats["scale"].astype(np.float64) / np.sqrt(stats["var"].astype(np.float64) + 1e-5)
    return got, want, np.abs(x * w) + np.abs(stats["bias"]) + np.abs(stats["mean"] * w)


def conv3x3(rng):
    kernel = (rng.normal(size=(3, 3, 64, 64)) / 24).astype(np.float32)  # HWIO
    x = np.maximum(rng.normal(size=(2, 16, 24, 64)), 0).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: fnn.Conv(64, (3, 3), padding=[(1, 1), (1, 1)], use_bias=False).apply(
        v, x))({"params": {"kernel": kernel}}, x))
    conv = torch.nn.Conv2d(64, 64, 3, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    terms = F.conv2d(torch.from_numpy(np.abs(x).astype(np.float64)).permute(0, 3, 1, 2),
                     torch.from_numpy(np.abs(kernel).astype(np.float64)).permute(3, 2, 0, 1), padding=1)
    return got, want, terms.permute(0, 2, 3, 1).numpy()


def class_head(rng):
    x = rng.normal(size=(2, 300, 256)).astype(np.float32)
    kernel = (rng.normal(size=(256, 91)) / 16).astype(np.float32)
    bias = (0.02 * rng.normal(size=91)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: fnn.Dense(91).apply(v, x))({"params": {"kernel": kernel, "bias": bias}},
                                                                        x))
    head = torch.nn.Linear(256, 91)
    with torch.no_grad():
        head.weight.copy_(torch.from_numpy(kernel.T))
        head.bias.copy_(torch.from_numpy(bias))
        got = head(torch.from_numpy(x)).numpy()
    return got, want, np.abs(x).astype(np.float64) @ np.abs(kernel).astype(np.float64) + np.abs(bias)


@pytest.mark.parametrize("make,bound", [(frozen_bn, 4), (conv3x3, 5), (class_head, 4.5)],
                         ids=["frozen_batch_norm", "conv3x3", "class_head"])
def test_module_matches_jax_within_its_ulps(make, bound):
    worst = 0.0
    for seed in SEEDS:
        got, want, terms = make(np.random.default_rng(seed))
        assert got.shape == want.shape
        worst = max(worst, float(spacing_units(got, want, terms).max()))
    assert worst <= bound, f"{make.__name__}: {worst} ulps of its terms against the JAX module (bound {bound})"
