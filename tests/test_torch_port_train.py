"""The port's train slice against the JAX package, at the tiny hybrid config
of tests/torch_port_common.py, float32, inputs from numpy seeds.

Checked: the box ops and focal losses; the plain assignment against JAX's
``batched_assignment`` and scipy, exactly; the CDN mask, slot layout, match
indices and noised queries, exactly, with the draws made by ``jax.random``
from the module's key split; every weighted term of ``compute_loss`` (rtol
1e-4, atol 1e-6); the attention mask, the neck BatchNorm's train mode and
the decoder's detaches (the train-path faults of the eval port); the
parameter groups and frozen parameters; one optimizer step against optax
(1e-6); and one whole train step through ``jax.value_and_grad`` (losses,
every gradient through the exported gradient tree with max |d| <=
1e-3 max |g| + 1e-6 per tensor, the BatchNorm statistics and the
assignments)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from salience_detr_tpu.engine import optim as jax_optim
from salience_detr_tpu.models.backbones.resnet import frozen_param_predicate
from salience_detr_tpu.models.bricks import denoising as jax_dn
from salience_detr_tpu.models.bricks.attention import MultiheadAttention as JaxMHA
from salience_detr_tpu.models.bricks.criterion import Targets as JaxTargets
from salience_detr_tpu.models.bricks.criterion import compute_matching_cost as jax_matching_cost
from salience_detr_tpu.models.bricks.criterion import default_weight_dict as jax_weight_dict
from salience_detr_tpu.models.detectors.salience_detr import compute_loss as jax_compute_loss
from salience_detr_tpu.models.factory import build_salience_detr as build_jax
from salience_detr_tpu.models.necks.repnet import ConvBNAct as JaxConvBNAct
from salience_detr_tpu.ops import boxes as jax_boxes
from salience_detr_tpu.ops import losses as jax_losses
from salience_detr_tpu.ops.hungarian import batched_assignment as jax_assignment
from salience_detr_tpu.utils.weight_converter import _conv_bn_act, _mha
from salience_detr_torch.engine.optim import (
    build_optimizer,
    clip_grad_global_norm_,
    make_lr_schedule,
    named_param_groups,
    set_lr,
)
from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
from salience_detr_torch.models.bricks import denoising as dn
from salience_detr_torch.models.bricks.attention import MultiheadAttention
from salience_detr_torch.models.bricks.criterion import Targets, default_weight_dict
from salience_detr_torch.models.detectors.salience_detr import compute_loss
from salience_detr_torch.models.factory import SalienceDETRConfig, build_criteria, build_salience_detr
from salience_detr_torch.models.necks.repnet import ConvBNAct
from salience_detr_torch.ops import boxes, losses
from salience_detr_torch.ops.hungarian import batched_assignment_plain
from salience_detr_torch.parallel.train_step import forward_and_loss
from salience_detr_torch.weights import converter_rules, state_dict_from_jax
from tests.torch_port_common import (
    CANVAS,
    TINY_JAX,
    export_subtree,
    jax_variable_shapes,
    random_variables,
    t,
    tiny_configs,
)

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6


def random_boxes(rng, shape):
    """normalised cxcywh boxes inside the image."""
    cxy = rng.uniform(0.25, 0.7, shape + (2,))
    wh = rng.uniform(0.05, 0.25, shape + (2,))
    return np.concatenate([cxy, wh], -1).astype(np.float32)


# ---------------------------------------------------------------- ops


@pytest.mark.parametrize("name", [
    "box_xyxy_to_cxcywh", "box_area", "box_iou_pairwise", "generalized_box_iou_pairwise",
    "box_iou_elementwise", "generalized_box_iou_elementwise",
])
def test_box_ops(name):
    rng = np.random.default_rng(0)
    a = np.asarray(jax_boxes.box_cxcywh_to_xyxy(jnp.asarray(random_boxes(rng, (2, 7)))))
    b = np.asarray(jax_boxes.box_cxcywh_to_xyxy(jnp.asarray(random_boxes(rng, (2, 7)))))
    args = (a,) if name in ("box_xyxy_to_cxcywh", "box_area") else (a, b)
    want = getattr(jax_boxes, name)(*map(jnp.asarray, args))
    got = getattr(boxes, name)(*map(t, args))
    for w, g in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["sigmoid_focal_loss", "vari_sigmoid_focal_loss"])
def test_focal_losses_and_their_gradients(name):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 9, 5)).astype(np.float32) * 3
    targets = (rng.uniform(size=(2, 9, 5)) < 0.2).astype(np.float32)
    score = rng.uniform(size=(2, 9)).astype(np.float32)
    mask = (rng.uniform(size=(1, 9, 1)) < 0.7)
    extra = (score,) if name.startswith("vari") else ()

    def jax_fn(x):
        return getattr(jax_losses, name)(x, jnp.asarray(targets), *map(jnp.asarray, extra), 3.0,
                                         mask=jnp.asarray(mask))

    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(logits))
    x = t(logits).requires_grad_()
    got = getattr(losses, name)(x, t(targets), *map(t, extra), 3.0, mask=t(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-7)


# ---------------------------------------------------------------- assignment


def total_cost(cost, gt_to_query, valid):
    used = [int(q) for q, v in zip(gt_to_query, valid) if v]
    assert all(q >= 0 for q in used) and len(set(used)) == len(used)
    return sum(cost[int(q), j] for j, (q, v) in enumerate(zip(gt_to_query, valid)) if v)


def hungarian_case(name):
    """The cases of tests/test_hungarian.py, as (cost (B, N, M), valid (B, M))."""
    rng = np.random.default_rng({"square": 0, "padded": 1, "detr": 2, "none": 3, "batched": 4}[name])
    if name == "square":
        return rng.normal(size=(5, 40, 40)).astype(np.float32) * 10, np.ones((5, 40), bool)
    if name == "padded":
        valid = np.zeros((1, 25), bool)
        valid[:, :17] = True
        return rng.uniform(-10, 30, size=(1, 120, 25)).astype(np.float32), valid
    if name == "detr":
        cost = (2 * rng.uniform(-2, 2, (1, 300, 12)) + 5 * rng.uniform(0, 4, (1, 300, 12))
                + 2 * rng.uniform(-1, 1, (1, 300, 12)))
        return cost.astype(np.float32), np.ones((1, 12), bool)
    if name == "none":
        return rng.normal(size=(2, 30, 6)).astype(np.float32), np.zeros((2, 6), bool)
    valid = np.arange(10)[None] < np.array([[10], [3], [0], [7]])
    return rng.normal(size=(4, 50, 10)).astype(np.float32), valid


@pytest.mark.parametrize("case", ["square", "padded", "detr", "none", "batched"])
def test_plain_assignment_vs_jax_and_scipy(case):
    cost, valid = hungarian_case(case)
    got = batched_assignment_plain(t(cost), t(valid)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jax_assignment(jnp.asarray(cost), jnp.asarray(valid))))
    for b in range(cost.shape[0]):
        assert np.all(got[b][~valid[b]] == -1)
        cols = np.flatnonzero(valid[b])
        r, c = linear_sum_assignment(cost[b][:, cols])
        np.testing.assert_allclose(total_cost(cost[b], got[b], valid[b]), cost[b][r, c].sum(), rtol=1e-6)


# ---------------------------------------------------------------- CDN


@pytest.mark.parametrize("counts,dn_nums", [((3, 1), 4), ((2, 2), 4), ((0, 0), 4), ((24, 7, 40, 1), 100)])
def test_cdn_layout_mask_and_match_indices(counts, dn_nums):
    valid = np.arange(max(max(counts), 1))[None] < np.asarray(counts)[:, None]
    _, jm, jg = jax_dn.cdn_meta(jnp.asarray(valid), dn_nums)
    m, g = dn.cdn_meta(counts, dn_nums)
    assert (m, g) == (int(jm), int(jg))
    cap, nq = 2 * dn_nums, 11
    for got, want in zip(dn.cdn_slot_layout(m, g, cap, "cpu"), jax_dn.cdn_slot_layout(jm, jg, cap)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mask = dn.cdn_attn_mask(m, g, cap, nq, "cpu")
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jax_dn.cdn_attn_mask_dynamic(jm, jg, cap, nq)))
    assert not bool(mask.all(-1).any()), "a fully blocked row has no softmax"
    for got, want in zip(dn.cdn_match_indices(m, g, dn_nums, "cpu"), jax_dn.cdn_match_indices(jm, jg, dn_nums)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def jax_cdn_draws(module, rng, batch):
    """The draws GenerateCDNQueries makes from its key: the same split and
    the same calls, as (flip, rand_labels, sign, part) JAX arrays."""
    k_label, k_flip, k_sign, k_part = jax.random.split(rng, 4)
    shape = (batch, module.num_denoising_queries)
    return (
        jax.random.uniform(k_flip, shape) < module.label_noise_prob * 0.5,
        jax.random.randint(k_label, shape, 0, module.num_classes),
        jax.random.randint(k_sign, shape + (4,), 0, 2).astype(jnp.float32) * 2.0 - 1.0,
        jax.random.uniform(k_part, shape + (4,)),
    )


def torch_draws(flip, rand_labels, sign, part):
    return dn.CDNDraws(t(flip), t(rand_labels).long(), t(sign), t(part))


@pytest.mark.parametrize("counts", [(3, 1), (4, 4), (0, 0)])
def test_noised_queries_with_jax_draws(counts):
    rng = np.random.default_rng(5)
    B, M, K, C, NUMS = 2, 4, 5, 8, 4
    labels = rng.integers(0, K, (B, M)).astype(np.int32)
    gt = random_boxes(rng, (B, M))
    valid = np.arange(M)[None] < np.asarray(counts)[:, None]
    table = rng.normal(size=(K, C)).astype(np.float32)
    jmod = jax_dn.GenerateCDNQueries(num_classes=K, label_embed_dim=C, denoising_nums=NUMS)
    key = jax.random.PRNGKey(7)
    want_l, want_b, _, _ = jmod.apply({"params": {"label_encoder": jnp.asarray(table)}},
                                      jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(valid), key)
    module = dn.GenerateCDNQueries(K, C, NUMS)
    module.label_encoder.weight.data.copy_(t(table))
    m, g = dn.cdn_meta(counts, NUMS)
    with torch.no_grad():
        draws = torch_draws(*jax_cdn_draws(jmod, key, B))
        got_l, got_b = module(t(labels).long(), t(gt), t(valid), m, g, draws)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- faults of the eval port


@pytest.mark.parametrize("mask_dims", [2, 3])
def test_attention_mask_polarity(mask_dims):
    """True means blocked, as in the JAX package (SDPA's boolean mask means
    the opposite)."""
    C, H, B, Q = 16, 4, 2, 11
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(B, Q, C)).astype(np.float32) for _ in range(3))
    mask = np.asarray(dn.cdn_attn_mask(2, 2, 8, Q - 8, "cpu"))
    if mask_dims == 3:
        mask = np.stack([mask, np.asarray(dn.cdn_attn_mask(3, 1, 8, Q - 8, "cpu"))])
    jmod = JaxMHA(C, H)
    params = jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, (q, k, v, mask)))
    want = jmod.apply(params, *map(jnp.asarray, (q, k, v, mask)))
    tmod = MultiheadAttention(C, H)
    tmod.load_state_dict(export_subtree({"params": {"m": params["params"]}}, _mha("m", "m", C), "m."))
    with torch.no_grad():
        got = tmod(t(q), t(k), t(v), t(mask))
        unmasked = tmod(t(q), t(k), t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert not torch.allclose(got, unmasked, atol=1e-3)


def test_neck_batchnorm_trains_as_flax():
    """Train mode: batch statistics, flax's running update with the biased
    variance; the outputs and the updated statistics match."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 6, 8)).astype(np.float32) * 2 + 0.5  # NHWC
    jmod = JaxConvBNAct(12, 3)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32), variables["batch_stats"])}
    want, mutated = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tmod = ConvBNAct(8, 12, 3)
    sd = export_subtree({c: {"m": variables[c]} for c in variables}, _conv_bn_act("m", "m"), "m.")
    tmod.load_state_dict(sd, strict=False)  # strict but for num_batches_tracked
    tmod.train()
    got = tmod(t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    new = export_subtree({"params": {"m": variables["params"]}, "batch_stats": {"m": mutated["batch_stats"]}},
                         _conv_bn_act("m", "m"), "m.")
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(tmod[1], name).numpy(), new[f"1.{name}"].numpy(), rtol=1e-5, atol=1e-6)


def test_decoder_detaches_refinement_as_jax():
    """Three decoder layers: the class logits of layer 1 and the boxes of
    layer 2 get no gradient from layer 0's box head (the layer input and the
    refinement input are detached), while layer 1's boxes do (look-forward-
    twice)."""
    cfg = SalienceDETRConfig(**dict(tiny_configs()[1].__dict__, num_decoder_layers=3))
    model, _ = build_salience_detr(cfg, torch.device("cpu"))
    rng = np.random.default_rng(8)
    images = t(rng.normal(size=(1, 3, *CANVAS)).astype(np.float32))
    sizes = torch.tensor([list(CANVAS)])
    head = model.transformer.decoder.bbox_head[0]
    torch.nn.init.normal_(head.layers[-1].weight, std=0.1)

    def grad_of(select):
        model.zero_grad()
        out = model(images, sizes)
        select(out).sum().backward()
        return float(sum(p.grad.abs().sum() for p in head.parameters() if p.grad is not None))

    assert grad_of(lambda o: o["pred_class"][1]) == 0.0
    assert grad_of(lambda o: o["pred_coord"][2]) == 0.0
    assert grad_of(lambda o: o["pred_coord"][1]) > 0.0


# ---------------------------------------------------------------- losses


def loss_inputs(seed=9):
    rng = np.random.default_rng(seed)
    L, B, Q, K, NDN, M = 2, 2, 30, 5, 8, 4
    counts = (3, 1)
    shapes = [(12, 16), (6, 8), (3, 4), (2, 2)]
    outputs = {
        "pred_class": rng.normal(size=(L, B, Q, K)) * 2,
        "pred_coord": random_boxes(rng, (L, B, Q)),
        "enc_class": rng.normal(size=(B, Q, K)) * 2,
        "enc_coord": random_boxes(rng, (B, Q)),
        "dn_class": rng.normal(size=(L, B, NDN, K)) * 2,
        "dn_coord": random_boxes(rng, (L, B, NDN)),
        "salience": [rng.normal(size=(B, h, w, 1)) for h, w in shapes],
    }
    outputs = {k: [a.astype(np.float32) for a in v] if isinstance(v, list) else v.astype(np.float32)
               for k, v in outputs.items()}
    outputs["feature_strides"] = [(CANVAS[0] / h, CANVAS[1] / w) for h, w in shapes]
    labels = rng.integers(0, K, (B, M)).astype(np.int32)
    gt = random_boxes(rng, (B, M))
    valid = np.arange(M)[None] < np.asarray(counts)[:, None]
    sizes = np.asarray([list(CANVAS), [70, 101]], np.int32)
    return outputs, labels, gt, valid, counts, sizes


def test_compute_loss_terms():
    outputs, labels, gt, valid, counts, sizes = loss_inputs()
    jcfg, tcfg = tiny_configs()
    _, jcrit, jsal, _ = build_jax(jcfg)
    m, g = dn.cdn_meta(counts, jcfg.denoising_nums)
    num_boxes = float(sum(counts))
    jout = {k: [jnp.asarray(a) for a in v] if k == "salience" else (v if k == "feature_strides" else jnp.asarray(v))
            for k, v in outputs.items()}
    jout.update(dn_m=jnp.int32(m), dn_groups=jnp.int32(g))
    want = jax_compute_loss(jout, JaxTargets(*map(jnp.asarray, (labels, gt, valid))), jnp.asarray(sizes),
                            jcrit, jsal, jnp.float32(num_boxes), jax_weight_dict(2), jcfg.denoising_nums)
    tout = {k: [t(a) for a in v] if k == "salience" else (v if k == "feature_strides" else t(v))
            for k, v in outputs.items()}
    tout.update(dn_m=m, dn_groups=g)
    crit, sal = build_criteria(tcfg)
    targets = Targets(t(labels).long(), t(gt), t(valid), counts)
    got = compute_loss(tout, targets, t(sizes), crit, sal, num_boxes, default_weight_dict(2),
                       tcfg.denoising_nums)
    assert set(got) == set(want) and len(got) == 3 * (2 * 2 + 1) + 1
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)


# ---------------------------------------------------------------- optimizer


def flax_path_of(rules):
    """torch parameter name -> the flax params paths (without "params/")."""
    paths = {}
    for src, dst, _ in rules:
        if dst.startswith("params/"):
            paths.setdefault(src, []).append(tuple(dst.split("/")[1:]))
    return paths


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_param_groups_and_frozen_params(which):
    cfg = tiny_configs()[1] if which == "tiny" else load_config(DEFAULT_CONFIG)
    model, _ = build_salience_detr(cfg, torch.device("cpu"))
    groups = named_param_groups(model)
    paths = flax_path_of(converter_rules(cfg))
    frozen = frozen_param_predicate(cfg.backbone_freeze_indices)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(paths)
    for name, param in model.named_parameters():
        jax_groups = {jax_optim.param_group_of(p) for p in paths[name]}
        assert len(jax_groups) == 1, (name, jax_groups)
        is_frozen = all(p[0] == "backbone" and frozen(p[1:]) for p in paths[name])
        assert param.requires_grad == (not is_frozen), name
        if param.requires_grad:
            assert groups[name] == jax_groups.pop(), name
    assert len(groups) == sum(p.requires_grad for p in model.parameters())


@pytest.fixture(scope="module")
def tiny_jax():
    jcfg, tcfg = tiny_configs()
    jmodel, jcrit, jsal, _ = build_jax(jcfg)
    variables = random_variables(jax_variable_shapes(jmodel), seed=0)
    return jcfg, tcfg, jmodel, jcrit, jsal, variables


def test_optimizer_steps_match_optax(tiny_jax, train_step_run):
    """Two steps from the same parameters and gradients, the JAX train step's
    gradients and then random ones (norms above the clip, so clipping acts):
    the port's AdamW groups, hand clip and schedule against the JAX optax
    chain."""
    jcfg, tcfg, _, _, _, variables = tiny_jax
    params = variables["params"]
    schedule = jax_optim.make_lr_schedule(1e-4, 3, milestones=(10,), warmup_steps=3)
    tx = jax_optim.build_optimizer(params, schedule, 1e-4, max_norm=0.1,
                                   frozen_predicate=frozen_param_predicate(jcfg.backbone_freeze_indices))
    state = tx.init(params)
    update = jax.jit(tx.update)
    model, _ = build_salience_detr(tcfg, torch.device("cpu"))
    model.load_state_dict(state_dict_from_jax(variables, tcfg))
    opt = build_optimizer(model, 1e-4, 1e-4)
    port_schedule = make_lr_schedule(1e-4, 3, (10,), warmup_steps=3)
    trainable = [p for p in model.parameters() if p.requires_grad]
    rng = np.random.default_rng(10)
    for step in range(2):
        grads = train_step_run["jgrads"] if step == 0 else jax.tree.map(
            lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32) * 0.01, params)
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        exported = state_dict_from_jax({**variables, "params": grads}, tcfg)
        for name, p in model.named_parameters():
            p.grad = exported[name].clone() if p.requires_grad else None
        clip_grad_global_norm_(trainable, 0.1)
        set_lr(opt, port_schedule(step))
        opt.step()
    want = state_dict_from_jax({**variables, "params": params}, tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- whole train step


@pytest.fixture(scope="module")
def train_step_run(tiny_jax):
    return run_tiny_train_step(*tiny_jax)


def run_tiny_train_step(jcfg, tcfg, jmodel, jcrit, jsal, variables):
    """One tiny train step in both packages from the same variables, batch
    and CDN draws: B=2, one image padded, 3 and 1 valid gts of 4 slots (so
    m=3, g=1 and 2 of the 8 CDN slots are dead)."""
    rng = np.random.default_rng(11)
    B, M, counts = 2, 4, (3, 1)
    images = rng.normal(size=(B, *CANVAS, 3)).astype(np.float32)
    sizes = np.asarray([list(CANVAS), [70, 101]], np.int32)
    labels = rng.integers(0, jcfg.num_classes, (B, M)).astype(np.int32)
    gt = random_boxes(rng, (B, M))
    valid = np.arange(M)[None] < np.asarray(counts)[:, None]
    jtargets = JaxTargets(*map(jnp.asarray, (labels, gt, valid)))
    num_boxes = float(sum(counts))
    weights = jax_weight_dict(jcfg.num_decoder_layers)
    key = jax.random.PRNGKey(12)
    captured = {}

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, jax_dn.GenerateCDNQueries) and context.method_name == "__call__":
            # under jit the draws are tracers: a callback brings them out
            jax.debug.callback(
                lambda *a: captured.update(draws=[np.asarray(x) for x in a]),
                *jax_cdn_draws(context.module, args[3], args[0].shape[0]),
            )
        return next_fun(*args, **kwargs)

    def loss_fn(params):
        vs = {"params": params, "frozen": variables["frozen"], "batch_stats": variables["batch_stats"]}
        outputs, mutated = jmodel.apply(vs, jnp.asarray(images), jnp.asarray(sizes), jtargets, train=True,
                                        rngs={"denoising": key}, mutable=["batch_stats"])
        loss_terms = jax_compute_loss(outputs, jtargets, jnp.asarray(sizes), jcrit, jsal,
                                      jnp.float32(num_boxes), weights, jmodel.denoising_nums)
        total = sum(jnp.asarray(v, jnp.float32) for v in loss_terms.values())
        keep = {k: outputs[k] for k in ("pred_class", "pred_coord", "enc_class", "enc_coord")}
        return total, (loss_terms, mutated["batch_stats"], keep)

    with fnn.intercept_methods(interceptor):
        (total, (jlosses, new_stats, jout)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
    jax.effects_barrier()

    def jax_matches(logits, coords):
        cost = jax_matching_cost(logits, coords, jtargets)
        return np.asarray(jax_assignment(cost, jtargets.valid))

    jmatches = [jax_matches(jout["pred_class"][i], jout["pred_coord"][i])
                for i in range(jcfg.num_decoder_layers)] + [jax_matches(jout["enc_class"], jout["enc_coord"])]
    exported = state_dict_from_jax(
        {"params": grads, "frozen": variables["frozen"], "batch_stats": new_stats}, tcfg
    )

    model, _ = build_salience_detr(tcfg, torch.device("cpu"))
    model.load_state_dict(state_dict_from_jax(variables, tcfg))
    crit, sal = build_criteria(tcfg)
    batch = {
        "images": t(images).permute(0, 3, 1, 2).contiguous(),
        "image_sizes": t(sizes).long(),
        "targets": Targets(t(labels).long(), t(gt), t(valid), counts),
    }
    draws = torch_draws(*captured["draws"])
    model.train()
    ptotal, plosses, pout = forward_and_loss(model, batch, draws, crit, sal,
                                             default_weight_dict(tcfg.num_decoder_layers))
    ptotal.backward()
    pmatches = [crit.match(pout["pred_class"][i], pout["pred_coord"][i], batch["targets"]).numpy()
                for i in range(tcfg.num_decoder_layers)]
    pmatches.append(crit.match(pout["enc_class"], pout["enc_coord"], batch["targets"]).numpy())
    return dict(jlosses=jlosses, jtotal=float(total), jgrads=grads, exported=exported, jmatches=jmatches,
                model=model, plosses=plosses, ptotal=ptotal.item(), pmatches=pmatches)


def check_step_losses(r):
    assert set(r["plosses"]) == set(r["jlosses"])
    for k, v in r["jlosses"].items():
        np.testing.assert_allclose(r["plosses"][k].item(), float(v), rtol=LOSS_RTOL, atol=LOSS_ATOL, err_msg=k)
    np.testing.assert_allclose(r["ptotal"], r["jtotal"], rtol=LOSS_RTOL)


def check_step_assignments(r):
    for layer, (got, want) in enumerate(zip(r["pmatches"], r["jmatches"])):
        np.testing.assert_array_equal(got, want, err_msg=f"assignment {layer}")


def check_step_gradients(r):
    """Every trainable parameter's gradient against the exported JAX
    gradient, max |d| <= 1e-3 max |g| + 1e-6; returns how many."""
    checked = 0
    for name, p in r["model"].named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        want = r["exported"][name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        bound = 1e-3 * np.abs(want).max() + 1e-6
        assert np.abs(got - want).max() <= bound, (name, np.abs(got - want).max(), bound)
        checked += 1
    return checked


def test_train_step_losses(train_step_run):
    check_step_losses(train_step_run)


def test_train_step_assignments(train_step_run):
    check_step_assignments(train_step_run)


def test_train_step_gradients(train_step_run):
    assert check_step_gradients(train_step_run) > 300


def test_train_step_batch_stats(train_step_run):
    r = train_step_run
    buffers = dict(r["model"].named_buffers())
    names = [k for k in buffers if ".neck." in k and k.endswith(("running_mean", "running_var"))]
    assert len(names) > 50
    for name in names:
        np.testing.assert_allclose(buffers[name].numpy(), r["exported"][name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_tiny_configs_agree_on_train_fields():
    jcfg, tcfg = tiny_configs()
    for f in ("denoising_nums", "backbone_freeze_indices", "cost_class", "cost_bbox", "cost_giou",
              "focal_alpha", "focal_gamma"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    assert TINY_JAX["denoising_nums"] == tcfg.denoising_nums


# ---------------------------------------------------------------- entry point


def tiny_trainer(steps):
    from salience_detr_torch.train import TRAIN_CONFIG, Trainer
    from salience_detr_torch.utils.config import Config

    tc = Config(str(TRAIN_CONFIG), max_gt=6, train_canvas=CANVAS, print_freq=1).to_dict()
    return Trainer(tiny_configs()[1], "cpu", seed=1, steps_per_epoch=steps, train_cfg=tc)


def test_trainer_trains_through_train_one_epoch():
    from salience_detr_torch.engine.train import train_one_epoch

    trainer = tiny_trainer(2)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    steps, metrics = train_one_epoch(trainer.step, trainer.batches(2, seed=1, counts=(3, 1)),
                                     trainer.generator, 0, trainer.print_freq)
    assert steps == 2
    assert set(metrics) == set(default_weight_dict(2)) | {"loss", "grad_norm"}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert trainer.model.training
    for n, p in trainer.model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, before[n]), n
    moved = sum(not torch.equal(p, before[n]) for n, p in trainer.model.named_parameters())
    assert moved > 0.9 * sum(p.requires_grad for p in trainer.model.parameters())


def test_train_one_epoch_raises_on_a_nonfinite_loss():
    from salience_detr_torch.engine.train import train_one_epoch

    def step(batch, generator):
        return {"loss": torch.tensor(float("nan")), "grad_norm": torch.tensor(1.0)}

    with pytest.raises(FloatingPointError):
        train_one_epoch(step, [None], None, 0, print_freq=1)


def test_train_cli_needs_cuda(monkeypatch):
    from salience_detr_torch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        train.main(["--steps", "1"])
