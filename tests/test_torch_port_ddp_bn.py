"""The neck's synced BatchNorm (``models/layers.py`` ``BatchNorm2d`` with a
process group) on 2 gloo ranks in subprocesses
(``salience_detr_torch.tools.ddp_check bn``), the batch split 2+2 and 1+1,
against the port's ``BatchNorm2d`` and flax's ``nn.BatchNorm`` on the whole
batch in train mode: the outputs and input gradients (the ranks' rows put
together), the weight and bias gradients (the ranks' local sums added, as
DDP's all-reduce adds them before it averages) and the running statistics
(the same on every rank), at rtol 1e-5 / atol 1e-6.  At the 1+1 split each
rank holds one image, whose own statistics are far from the batch's."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from salience_detr_torch.models.layers import BatchNorm2d
from salience_detr_torch.tools import ddp_check

RTOL, ATOL = 1e-5, 1e-6
C, H, W = 8, 5, 6


def inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "x": (rng.normal(size=(batch, C, H, W)) * 2 + 0.5).astype(np.float32),
        "dy": rng.normal(size=(batch, C, H, W)).astype(np.float32),
        "weight": rng.uniform(0.5, 1.5, C).astype(np.float32),
        "bias": rng.normal(size=C).astype(np.float32) * 0.1,
        "running_mean": rng.normal(size=C).astype(np.float32) * 0.1,
        "running_var": rng.uniform(0.5, 1.5, C).astype(np.float32),
    }


def port_whole_batch(d):
    layer = BatchNorm2d(C)
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(layer, name).copy_(torch.from_numpy(d[name]))
    layer.train()
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    y = layer(x)
    y.backward(torch.from_numpy(d["dy"]))
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(), "dweight": layer.weight.grad.numpy(),
            "dbias": layer.bias.grad.numpy(), "running_mean": layer.running_mean.numpy(),
            "running_var": layer.running_var.numpy()}


def flax_whole_batch(d):
    """flax's train-mode BatchNorm on NHWC: outputs, the VJP with dy, and the
    updated batch statistics (momentum 0.9, the port's 0.1)."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    x = jnp.asarray(d["x"].transpose(0, 2, 3, 1))
    variables = {"params": {"scale": jnp.asarray(d["weight"]), "bias": jnp.asarray(d["bias"])},
                 "batch_stats": {"mean": jnp.asarray(d["running_mean"]), "var": jnp.asarray(d["running_var"])}}

    def f(params, x):
        return bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, mutable=["batch_stats"])

    (y, mutated), vjp = jax.vjp(f, variables["params"], x)
    dparams, dx = vjp((jnp.asarray(d["dy"].transpose(0, 2, 3, 1)),
                       jax.tree.map(jnp.zeros_like, mutated)))
    return {"y": np.asarray(y).transpose(0, 3, 1, 2), "dx": np.asarray(dx).transpose(0, 3, 1, 2),
            "dweight": np.asarray(dparams["scale"]), "dbias": np.asarray(dparams["bias"]),
            "running_mean": np.asarray(mutated["batch_stats"]["mean"]),
            "running_var": np.asarray(mutated["batch_stats"]["var"])}


@pytest.fixture(scope="module", params=[4, 2], ids=["split_2_2", "split_1_1"])
def synced(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"bn{request.param}")
    d = inputs(request.param, seed=request.param)
    np.savez(root / "inputs.npz", **d)
    ddp_check.launch(["-m", "salience_detr_torch.tools.ddp_check", "bn", "--inputs", str(root / "inputs.npz"),
                      "--out", str(root), "--device", "cpu"], world=2, timeout=180)
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(2)]
    got = {"y": np.concatenate([r["y"] for r in ranks]), "dx": np.concatenate([r["dx"] for r in ranks]),
           "dweight": ranks[0]["dweight"] + ranks[1]["dweight"], "dbias": ranks[0]["dbias"] + ranks[1]["dbias"],
           "running_mean": ranks[0]["running_mean"], "running_var": ranks[0]["running_var"]}
    return d, ranks, got


@pytest.mark.parametrize("reference", ["port", "flax"])
def test_synced_batch_norm_equals_the_whole_batch(synced, reference):
    d, _, got = synced
    want = port_whole_batch(d) if reference == "port" else flax_whole_batch(d)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=k)


def test_synced_statistics_are_the_same_on_every_rank(synced):
    d, ranks, _ = synced
    for k in ("running_mean", "running_var"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
        assert not np.allclose(ranks[0][k], d[k])
    # each rank's local statistics would differ: its rows alone
    half = d["x"][: len(d["x"]) // 2]
    assert not np.allclose(0.9 * d["running_mean"] + 0.1 * half.mean((0, 2, 3)), ranks[0]["running_mean"],
                           rtol=RTOL, atol=ATOL)
