"""The data-parallel train step (``parallel/train_step.py`` under a mesh)
against the JAX package's step on the global batch: the tiny config of
tests/torch_port_common.py from one exported init, a global batch of 4
images whose gt counts are (3, 1) on rank 0 and (1, 0) on rank 1 (the
ranks' largest counts differ from the global one, and one image has no gt),
3 steps on 2 gloo ranks in subprocesses
(``salience_detr_torch.tools.ddp_check step``).

The JAX ``make_train_step`` runs with ``make_mesh(2)``, sharding the global
batch over two of the 8 virtual CPU devices; each port rank gets the CDN
draws the JAX step made for the global (micro-)batch and keeps its rows.
Per step the losses averaged over the ranks, the total and ``grad_norm``
agree with the JAX step's at the paired tests' rtol 1e-3 / atol 1e-4, and
after the 3 steps every parameter and BatchNorm statistic does too.  (The
paired tests' bound relative to what the steps moved is not used against
JAX here: on this batch a few gradient entries near zero take the other
sign in the two packages, and AdamW's first steps move such an entry by
about +-lr either way; the port's one-process step differs from the JAX
step on the mesh as much as the data-parallel one does.)  Against the port's own one-process
step on the whole batches the bound is tighter: metrics at rtol 2e-5 /
atol 1e-6, states within 1e-4 of what the steps moved, plus an ulp (the ranks sum in
another order, and the synced BatchNorm takes flax's E[x^2] - E[x]^2 where
the local one takes the mean of squared deviations).  Both ranks end with
bitwise equal states.  ``accumulate_steps=2`` is the same with micro-batches
of 2 images, one a rank (tests/test_torch_port_ddp_accum.py)."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from salience_detr_torch.data.loader import pack_batch
from salience_detr_torch.parallel.mesh import Mesh
from salience_detr_torch.tools import ddp_check
from salience_detr_torch.weights import state_dict_from_jax
from tests import test_torch_port_train_pair as pair
from tests.test_torch_port_train import jax_cdn_draws, torch_draws
from tests.torch_port_common import CANVAS, TINY_TORCH, jax_variable_shapes, random_variables, tiny_configs
from tests.torch_port_common import two_torch_threads  # noqa: F401

RTOL, ATOL = pair.RTOL, pair.ATOL
TIGHT_RTOL, TIGHT_ATOL, TIGHT_MOVED = 2e-5, 1e-6, 1e-4
COUNTS = (3, 1, 1, 0)  # rank 0 holds (3, 1), rank 1 (1, 0)
SIZES = [(96, 128), (70, 101), (90, 120), (80, 128)]
MAX_GT, STEPS, STEPS_PER_EPOCH = 4, 3, 10


def global_batches(seed, steps=STEPS, counts=COUNTS):
    """``steps`` global batches of ``pack_batch`` arrays (each image's boxes
    random inside it)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        samples = []
        for (h, w), n in zip(SIZES, counts):
            x0, y0 = rng.uniform(0, 0.5, n) * w, rng.uniform(0, 0.5, n) * h
            bw, bh = rng.uniform(0.1, 0.5, n) * w, rng.uniform(0.1, 0.5, n) * h
            samples.append({"image": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                            "boxes": np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(np.float32),
                            "labels": rng.integers(1, 5, n)})
        out.append(pack_batch(samples, CANVAS, MAX_GT))
    return out


def write_spec(root, variables, tcfg, batches, draws, accumulate_steps):
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(TINY_TORCH))
    (root / "settings.json").write_text(json.dumps(dict(
        lr=pair.LR, weight_decay=pair.WD, betas=list(pair.BETAS), max_norm=pair.MAX_NORM,
        steps_per_epoch=STEPS_PER_EPOCH, accumulate_steps=accumulate_steps, seed=0)))
    torch.save(state_dict_from_jax(variables, tcfg), root / "state.pt")
    np.savez(root / "batches.npz", **{k: np.stack([b[k] for b in batches]) for k in batches[0]})
    torch.save([[tuple(d) for d in step] for step in draws], root / "draws.pt")
    return root


class MeshJaxSide(pair.JaxSide):
    """The paired tests' JAX side with its step on a mesh of ``world``
    devices.  Ordered effects are refused on more than one device, so the
    CDN draws are captured unordered, each with its micro-batch's labels,
    and put in micro-batch order by them."""

    def __init__(self, jcfg, variables, accumulate_steps, world):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pair, "jax_make_train_step",
                       functools.partial(pair.jax_make_train_step, mesh=jax_make_mesh(world)))
            super().__init__(jcfg, variables, STEPS_PER_EPOCH, accumulate_steps)
        self.accumulate_steps = accumulate_steps
        self.captured = []

    def interceptor(self, next_fun, args, kwargs, context):
        if isinstance(context.module, pair.jax_dn.GenerateCDNQueries) and context.method_name == "__call__":
            jax.debug.callback(lambda labels, *a: self.captured.append((np.asarray(labels), [np.asarray(x) for x in a])),
                               args[0], *jax_cdn_draws(context.module, args[3], args[0].shape[0]))
        return next_fun(*args, **kwargs)

    def step_with_draws(self, batch, key):
        """The step's metrics and its draws, one set per micro-batch in order."""
        self.captured = []
        metrics = self.step(batch, key)
        A = self.accumulate_steps
        micro = len(batch["labels"]) // A
        draws = []
        for a in range(A):
            labels = batch["labels"][a * micro:(a + 1) * micro]
            found = [d for lab, d in self.captured if np.array_equal(lab, labels)]
            assert found and all(all(np.array_equal(x, y) for x, y in zip(f, found[0])) for f in found), a
            draws.append(found[0])
        return metrics, draws


def run_ddp_pair(root, accumulate_steps, seed=0, world=2):
    """The JAX step on the mesh, the port's one-process step and its
    ``world``-rank step on the same init, batches and draws; returns (JAX
    metrics with the clip's norm, one-process result, per-rank results,
    init state, JAX state)."""
    jcfg, tcfg = tiny_configs()
    jmodel, *_ = build_jax(jcfg)
    variables = random_variables(jax_variable_shapes(jmodel), seed=seed)
    batches = global_batches(seed)
    jside = MeshJaxSide(jcfg, variables, accumulate_steps, world)
    jax_metrics, draws = [], []
    for i, batch in enumerate(batches):
        jm, step_draws = jside.step_with_draws(batch, 100 + i)
        jm["grad_norm_trainable"] = jside.norms[-1]
        jax_metrics.append(jm)
        draws.append([torch_draws(*d) for d in step_draws])
    spec = write_spec(root / "spec", variables, tcfg, batches, draws, accumulate_steps)
    one = ddp_check.run_step(str(spec), Mesh())
    out = root / "ranks"
    out.mkdir()
    ddp_check.launch(["-m", "salience_detr_torch.tools.ddp_check", "step", "--spec", str(spec), "--out", str(out)],
                     world, timeout=300)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(world)]
    return jax_metrics, one, ranks, state_dict_from_jax(variables, tcfg), jside.state_dict(tcfg)


def close_to_moved(got, want, start):
    """max |got - want| within TIGHT_MOVED of what the steps moved (max |want
    - start|), plus a float32 ulp of the values."""
    got, want, start = got.float(), want.float(), start.float()
    moved = float((want - start).abs().max())
    ulp = float(want.abs().max()) * 2.0**-23
    return float((got - want).abs().max()) <= TIGHT_MOVED * moved + ulp + 1e-7


def check_against_one_process(one, ranks, init):
    for step, (want, got) in enumerate(zip(one["metrics"], ranks[0]["metrics"])):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=TIGHT_RTOL, atol=TIGHT_ATOL, err_msg=f"step {step} {k}")
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["state"].items():
            assert torch.equal(r["state"][k], v), k
    for name, want in one["state"].items():
        if name not in init:  # num_batches_tracked, which no package exports
            assert torch.equal(ranks[0]["state"][name], want), name
            continue
        assert close_to_moved(ranks[0]["state"][name], want, init[name]), name


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    return run_ddp_pair(tmp_path_factory.mktemp("ddp_step"), accumulate_steps=1)


def test_ddp_steps_match_the_jax_step_on_the_global_batch(ddp_run):
    jax_metrics, _, ranks, init, jax_state = ddp_run
    pair.check_metrics(jax_metrics, ranks[0]["metrics"])
    for name, want in jax_state.items():
        np.testing.assert_allclose(ranks[0]["state"][name].float().numpy(), want.float().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    moved = [n for n in jax_state if not torch.equal(ranks[0]["state"][n], init[n])]
    assert len(jax_state) > 500 and len(moved) > 300
    # the ranks' own losses differ: each holds its rows' share
    assert ranks[0]["local"][0]["loss"] != ranks[1]["local"][0]["loss"]


def test_ddp_steps_match_the_one_process_step(ddp_run):
    _, one, ranks, init, _ = ddp_run
    check_against_one_process(one, ranks, init)
    stats = [n for n in init if ".neck." in n and n.endswith("running_var")]
    assert stats and all(not torch.equal(ranks[0]["state"][n], init[n]) for n in stats)
