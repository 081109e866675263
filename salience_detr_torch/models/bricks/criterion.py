"""Set criterion with Hungarian matching, for padded targets (port of
salience_detr_tpu/models/bricks/criterion.py).

Targets are padded to a static ``max_gt``: labels (B, M) int, boxes (B, M, 4)
normalised cxcywh, valid (B, M) bool with each image's valid gts first, and
``counts``, the per-image valid counts as host integers (the CDN layout reads
them, so that it costs no synchronisation).  The assignment runs in the
assignment kernel (ops/hungarian.py) on the device, one launch for all the
sets of a step, also for the mixed (Align-DETR) assignment of
``mixed_match_copies`` > 1, which matches each gt to up to that many
queries and scores the losses against the gts tiled that many times.
Every loss is computed in float32; call the criteria outside autocast.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from salience_detr_torch.models.bricks.denoising import cdn_slot_layout
from salience_detr_torch.ops.boxes import (
    box_cxcywh_to_xyxy,
    box_iou_elementwise,
    generalized_box_iou_elementwise,
    generalized_box_iou_pairwise,
)
from salience_detr_torch.ops.hungarian import batched_assignment, batched_mixed_assignment, copy_validity
from salience_detr_torch.ops.losses import sigmoid_focal_loss, vari_sigmoid_focal_loss
from salience_detr_torch.parallel.mesh import all_reduce_sum


class Shard(NamedTuple):
    """Where a rank's targets sit in the global (micro-)batch of a
    data-parallel step (``parallel/mesh.py``): the valid gts of every image
    of the global batch (host integers, from the step's one all-reduce), the
    rank's first row in it, and the world size.  The CDN layout, the gt
    normaliser and the salience loss's positives read the global batch
    through it."""

    counts: Tuple[int, ...]
    offset: int
    world: int


class Targets(NamedTuple):
    labels: torch.Tensor  # (B, M) int
    boxes: torch.Tensor  # (B, M, 4) normalised cxcywh
    valid: torch.Tensor  # (B, M) bool
    counts: Tuple[int, ...]  # valid gts per image, host integers
    shard: Optional[Shard] = None  # the global batch, in a data-parallel step


def global_counts(targets: Targets) -> Tuple[int, ...]:
    """The per-image valid gt counts of the global batch (the targets' own
    outside a data-parallel step)."""
    return targets.counts if targets.shard is None else targets.shard.counts


def normaliser(targets: Targets) -> float:
    """The gt normaliser ``num_boxes`` of a rank's losses: the global count
    clamped to at least 1 (the JAX step's), divided by the world size, so
    that the ranks' gradients averaged by DDP are the global batch's."""
    n = float(max(sum(global_counts(targets)), 1))
    return n if targets.shard is None else n / targets.shard.world


def _take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) at index (B, K) along dim 1 -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], index]


def compute_matching_cost(pred_logits, pred_boxes, targets: Targets, cost_class=2.0,
                          cost_bbox=5.0, cost_giou=2.0, focal_alpha=0.25, focal_gamma=2.0):
    """(B, Q, M) matching cost (the reference's hungarian_matcher.py:41-70),
    as the transposed view of a contiguous (B, M, Q) tensor: one gt's costs
    over the queries are contiguous, the layout the assignment kernel reads,
    so it needs no copy.  Each term is symmetric in its two box sets, so the
    values are those of the (B, Q, M) computation."""
    prob = pred_logits.float().sigmoid()
    pred_boxes = pred_boxes.float()
    neg_cost = -(1 - focal_alpha) * prob**focal_gamma * torch.log(1 - prob + 1e-6)
    pos_cost = -focal_alpha * (1 - prob) ** focal_gamma * torch.log(prob + 1e-6)
    labels = targets.labels.clamp(0, pred_logits.shape[-1] - 1)
    cls = (pos_cost - neg_cost).transpose(1, 2).gather(1, labels[:, :, None].expand(-1, -1, prob.shape[1]))
    tgt_boxes = targets.boxes.float()
    bbox = (tgt_boxes[:, :, None, :] - pred_boxes[:, None, :, :]).abs().sum(-1)
    giou = -generalized_box_iou_pairwise(box_cxcywh_to_xyxy(tgt_boxes), box_cxcywh_to_xyxy(pred_boxes))
    return (cost_bbox * bbox + cost_class * cls + cost_giou * giou).transpose(1, 2)


class SetCriterion:
    """Hungarian-matched detection loss; ``hybrid=True`` is the IoU-aware
    HybridSetCriterion variant Salience-DETR trains with.
    ``two_stage_binary_cls`` scores the encoder's proposals against class 0
    (foreground) for every gt; ``mixed_match_copies`` > 1 is the Align-DETR
    mixed assignment (each gt matched to up to that many queries).  Both are
    off in every shipped config."""

    def __init__(self, num_classes: int, cost_class: float = 2.0, cost_bbox: float = 5.0,
                 cost_giou: float = 2.0, alpha: float = 0.25, gamma: float = 2.0,
                 hybrid: bool = True, two_stage_binary_cls: bool = False, mixed_match_copies: int = 1):
        self.num_classes = num_classes
        self.cost_class = cost_class
        self.cost_bbox = cost_bbox
        self.cost_giou = cost_giou
        self.alpha = alpha
        self.gamma = gamma
        self.hybrid = hybrid
        self.two_stage_binary_cls = two_stage_binary_cls
        self.mixed_match_copies = mixed_match_copies

    def _cost(self, pred_logits, pred_boxes, targets: Targets) -> torch.Tensor:
        return compute_matching_cost(
            pred_logits, pred_boxes, targets, self.cost_class, self.cost_bbox, self.cost_giou,
            self.alpha, self.gamma,
        )

    @torch.no_grad()
    def match(self, pred_logits, pred_boxes, targets: Targets) -> torch.Tensor:
        """(B, M) int32 matched query per gt, -1 for padded gts."""
        return batched_assignment(self._cost(pred_logits, pred_boxes, targets), targets.valid)

    def tiled_targets(self, targets: Targets, num_queries: int) -> Targets:
        """The gts tiled ``mixed_match_copies`` times (copy-major), valid
        where the copy takes part in the mixed assignment over
        ``num_queries`` queries: the targets its (B, C * M) matches index."""
        C = self.mixed_match_copies
        B, M = targets.labels.shape
        valid = copy_validity(targets.valid, num_queries, C).reshape(B, C * M)
        counts = tuple(min((num_queries // 2) // max(n, 1), C) * n for n in targets.counts)
        return Targets(targets.labels.repeat(1, C), targets.boxes.repeat(1, C, 1), valid, counts)

    def match_mixed(self, pred_logits, pred_boxes, targets: Targets) -> Tuple[torch.Tensor, Targets]:
        """The mixed assignment: the (B, C * M) int32 query of each copy of
        each gt (-1 where the copy or the gt is not valid) and the tiled
        targets it indexes, so the losses downstream are unchanged."""
        return self._assign(pred_logits, pred_boxes, targets), self.tiled_targets(targets, pred_logits.shape[1])

    def encoder_targets(self, targets: Targets) -> Targets:
        """The encoder's targets: every label 0 with ``two_stage_binary_cls``."""
        if not self.two_stage_binary_cls:
            return targets
        return Targets(torch.zeros_like(targets.labels), targets.boxes, targets.valid, targets.counts)

    @torch.no_grad()
    def _assign(self, pred_logits, pred_boxes, targets: Targets) -> torch.Tensor:
        """:meth:`match`, or with ``mixed_match_copies`` > 1 the (B, C * M)
        mixed assignment."""
        if self.mixed_match_copies <= 1:
            return self.match(pred_logits, pred_boxes, targets)
        cost = self._cost(pred_logits, pred_boxes, targets)
        return batched_mixed_assignment(cost, targets.valid, self.mixed_match_copies)[0].flatten(1)

    @torch.no_grad()
    def match_sets(self, outputs_class, outputs_coord, enc_class, enc_coord,
                   targets: Targets) -> List[torch.Tensor]:
        """One assignment per decoder layer of ``outputs_*`` (L, B, Q, .) and
        one for the encoder's ``enc_*`` (B, Q', .) against
        :meth:`encoder_targets`, in that order: (B, M) each, or (B, C * M)
        over :meth:`tiled_targets` when mixed.  Each image of each set is
        its own problem, so the sets are stacked to (L + 1) * B images for
        one cost computation and one assignment launch; an encoder set with
        another query count is matched in its own call."""
        n_layers = outputs_class.shape[0]
        enc_targets = self.encoder_targets(targets)
        if enc_class.shape[1] == outputs_class.shape[2]:
            outputs_class = torch.cat([outputs_class, enc_class[None]])
            outputs_coord = torch.cat([outputs_coord, enc_coord[None]])
            enc_match = None
        else:
            enc_match = self._assign(enc_class, enc_coord, enc_targets)
        sets = outputs_class.shape[0]
        labels = targets.labels.repeat(n_layers, 1)
        if enc_match is None:
            labels = torch.cat([labels, enc_targets.labels])
        stacked = Targets(labels, targets.boxes.repeat(sets, 1, 1), targets.valid.repeat(sets, 1),
                          targets.counts * sets)
        matches = self._assign(outputs_class.flatten(0, 1), outputs_coord.flatten(0, 1), stacked)
        matches = list(matches.view(sets, targets.valid.shape[0], -1).unbind(0))
        return matches if enc_match is None else matches[:n_layers] + [enc_match]

    def calculate_loss(self, pred_logits, pred_boxes, targets: Targets, num_boxes,
                       gt_to_query: Optional[torch.Tensor] = None,
                       class_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The class, L1 and GIoU losses of one set; without ``gt_to_query``
        it matches first (mixed, against the tiled targets, when
        ``mixed_match_copies`` > 1)."""
        if gt_to_query is None:
            if self.mixed_match_copies > 1:
                gt_to_query, targets = self.match_mixed(pred_logits, pred_boxes, targets)
            else:
                gt_to_query = self.match(pred_logits, pred_boxes, targets)
        B, Q, K = pred_logits.shape
        valid = targets.valid
        q_idx = gt_to_query.long().clamp(0, Q - 1)
        # padded gts write into a throwaway slot Q, dropped below
        q_scatter = torch.where(valid, q_idx, torch.full_like(q_idx, Q))
        src_boxes = _take(pred_boxes.float(), q_idx)  # (B, M, 4)
        tgt_boxes = targets.boxes.float()

        target_classes = torch.full((B, Q + 1), self.num_classes, dtype=torch.long,
                                    device=pred_logits.device)
        target_classes = target_classes.scatter(1, q_scatter, targets.labels.long())[:, :Q]
        onehot = F.one_hot(target_classes, K + 1)[..., :K].float()
        src_xyxy = box_cxcywh_to_xyxy(src_boxes)
        tgt_xyxy = box_cxcywh_to_xyxy(tgt_boxes)
        if self.hybrid:
            iou = box_iou_elementwise(src_xyxy, tgt_xyxy).detach()
            iou = torch.where(valid, iou, torch.zeros_like(iou))
            target_score = torch.zeros(B, Q + 1, device=pred_logits.device)
            target_score = target_score.scatter(1, q_scatter, iou)[:, :Q]
            loss_class = vari_sigmoid_focal_loss(
                pred_logits, onehot, target_score, num_boxes, self.alpha, self.gamma, class_mask
            ) * Q
        else:
            loss_class = sigmoid_focal_loss(
                pred_logits, onehot, num_boxes, self.alpha, self.gamma, class_mask
            ) * Q
        zero = torch.zeros((), device=pred_logits.device)
        l1 = (src_boxes - tgt_boxes).abs().sum(-1)
        loss_bbox = torch.where(valid, l1, zero).sum() / num_boxes
        giou = generalized_box_iou_elementwise(src_xyxy, tgt_xyxy)
        loss_giou = torch.where(valid, 1.0 - giou, zero).sum() / num_boxes
        return {"loss_class": loss_class, "loss_bbox": loss_bbox, "loss_giou": loss_giou}

    def __call__(self, outputs_class, outputs_coord, enc_class, enc_coord, targets: Targets,
                 num_boxes) -> Dict[str, torch.Tensor]:
        """Final, auxiliary (one per earlier decoder layer) and encoder losses;
        all their assignments in one call of :meth:`match_sets`."""
        losses = {}
        n_layers = outputs_class.shape[0]
        matches = self.match_sets(outputs_class, outputs_coord, enc_class, enc_coord, targets)
        dec_targets, enc_targets = targets, self.encoder_targets(targets)
        if self.mixed_match_copies > 1:
            dec_targets = self.tiled_targets(dec_targets, outputs_class.shape[2])
            enc_targets = self.tiled_targets(enc_targets, enc_class.shape[1])
        for i in range(n_layers):
            layer = self.calculate_loss(outputs_class[i], outputs_coord[i], dec_targets, num_boxes,
                                        gt_to_query=matches[i])
            suffix = "" if i == n_layers - 1 else f"_{i}"
            losses.update({k + suffix: v for k, v in layer.items()})
        enc = self.calculate_loss(enc_class, enc_coord, enc_targets, num_boxes, gt_to_query=matches[-1])
        losses.update({k + "_enc": v for k, v in enc.items()})
        return losses

    def dn_loss(self, dn_class, dn_coord, targets: Targets, num_boxes, dn_query_idx, dn_gt_idx,
                pair_live, dn_m: int, dn_groups: int) -> Dict[str, torch.Tensor]:
        """Denoising losses: the positives of the live groups match their gts
        in order; dead pairs leave the box losses and dead slots the class
        loss."""
        M = targets.labels.shape[1]
        B = dn_class.shape[1]
        t_c = dn_gt_idx.clamp(0, M - 1)
        dn_targets = Targets(
            targets.labels[:, t_c], targets.boxes[:, t_c], targets.valid[:, t_c] & pair_live[None],
            targets.counts,
        )
        gt_to_query = dn_query_idx[None].expand(B, -1)
        _, _, slot_live = cdn_slot_layout(dn_m, dn_groups, dn_class.shape[2], dn_class.device)
        class_mask = slot_live[None, :, None]
        nb = num_boxes * float(dn_groups)
        losses = {}
        n_layers = dn_class.shape[0]
        for i in range(n_layers):
            layer = self.calculate_loss(dn_class[i], dn_coord[i], dn_targets, nb,
                                        gt_to_query=gt_to_query, class_mask=class_mask)
            suffix = "_dn" if i == n_layers - 1 else f"_dn_{i}"
            losses.update({k + suffix: v for k, v in layer.items()})
        return losses


class SalienceCriterion:
    """Supervision of the hierarchical salience maps (the reference's
    salience_detr.py:13-116).  With ``noise_scale`` > 0 and uniform draws
    (``uniform``: one (B, h * w) tensor in [0, 1) a level, or a
    ``generator`` to draw them), each level's target becomes (1 - s) *
    target + s * uniform and the positives are the targets above s / 2; the
    JAX package draws them only when given a key, and its train step gives
    none.  In a data-parallel step (``targets.shard``) the generator draws at
    the global batch's shape, the rank keeping its rows, and the positives
    are counted over the global batch."""

    def __init__(self, limit_range: Sequence[Tuple[float, float]] = (
                     (-1, 64), (64, 128), (128, 256), (256, 99999)),
                 noise_scale: float = 0.0, alpha: float = 0.25, gamma: float = 2.0):
        self.limit_range = limit_range
        self.noise_scale = noise_scale
        self.alpha = alpha
        self.gamma = gamma

    def __call__(self, foreground_mask: List[torch.Tensor], targets: Targets,
                 feature_strides: Sequence[Tuple[float, float]], image_sizes: torch.Tensor,
                 uniform: Optional[Sequence[torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """foreground_mask [(B, h, w, 1)] salience logits; image_sizes (B, 2)
        valid (h, w)."""
        noisy = self.noise_scale > 0 and (uniform is not None or generator is not None)
        sizes = image_sizes.float()
        scale = torch.stack([sizes[:, 1], sizes[:, 0], sizes[:, 1], sizes[:, 0]], -1)[:, None]
        gt_xyxy = box_cxcywh_to_xyxy(targets.boxes.float()) * scale  # (B, M, 4)
        valid = targets.valid
        mask_targets, flat_scores = [], []
        for level_idx, (mask, stride) in enumerate(zip(foreground_mask, feature_strides)):
            b, h, w, _ = mask.shape
            dev = mask.device
            cy, cx = torch.meshgrid(
                (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * stride[0],
                (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * stride[1],
                indexing="ij",
            )
            cx = cx.reshape(-1)[None, :, None]
            cy = cy.reshape(-1)[None, :, None]
            left = cx - gt_xyxy[:, None, :, 0]  # (B, S, M)
            top = cy - gt_xyxy[:, None, :, 1]
            right = gt_xyxy[:, None, :, 2] - cx
            bottom = gt_xyxy[:, None, :, 3] - cy
            borders = torch.stack([left, top, right, bottom], -1)
            in_boxes = (borders.amin(-1) > 0) & valid[:, None, :]
            lo, hi = self.limit_range[level_idx]
            max_border = borders.amax(-1)
            in_level = (max_border > lo) & (max_border <= hi)
            row = left + right
            col = top + bottom
            dx = (left - right) / torch.where(row == 0, torch.ones_like(row), row)
            dy = (top - bottom) / torch.where(col == 0, torch.ones_like(col), col)
            conf = torch.sqrt(dx**2 + dy**2) / 2
            conf_per_box = torch.where(in_boxes, 1.0 - conf, torch.zeros_like(conf))
            if conf_per_box.shape[-1]:
                tgt = conf_per_box.amax(-1)
            else:
                tgt = torch.zeros(b, h * w, device=dev)
            pos = (in_boxes & in_level).any(-1)
            tgt = torch.where(pos, tgt, torch.zeros_like(tgt))
            if noisy:
                if uniform is not None:
                    u = uniform[level_idx].to(dev, torch.float32)
                else:
                    # drawn at the global batch's shape, the rank keeping its rows
                    shard = targets.shard
                    rows = b if shard is None else len(shard.counts)
                    u = torch.rand((rows, h * w), generator=generator, device=generator.device).to(dev)
                    if shard is not None:
                        u = u[shard.offset:shard.offset + b]
                tgt = (1 - self.noise_scale) * tgt + self.noise_scale * u
            mask_targets.append(tgt)
            flat_scores.append(mask.reshape(b, h * w))
        mask_targets = torch.cat(mask_targets, 1)
        scores = torch.cat(flat_scores, 1).float()
        num_pos = (mask_targets > 0.5 * self.noise_scale).sum().float()
        if targets.shard is not None:  # the global batch's positives, clamped, over the world size
            num_pos = all_reduce_sum(num_pos).clamp(min=1.0) / targets.shard.world
        else:
            num_pos = num_pos.clamp(min=1.0)
        loss = sigmoid_focal_loss(scores, mask_targets, num_pos, self.alpha, self.gamma)
        return {"loss_salience": loss * scores.shape[1]}


def default_weight_dict(num_decoder_layers: int = 6) -> Dict[str, float]:
    """Loss weights (the reference's salience_detr_resnet50_800_1333.py:86-94)."""
    base = {"loss_class": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0}
    w = dict(base)
    w.update({k + "_dn": v for k, v in base.items()})
    for i in range(num_decoder_layers - 1):
        w.update({f"{k}_{i}": v for k, v in base.items()})
        w.update({f"{k}_dn_{i}": v for k, v in base.items()})
    w.update({k + "_enc": v for k, v in base.items()})
    w["loss_salience"] = 2.0
    return w
