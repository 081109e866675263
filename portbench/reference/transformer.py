"""Salience transformer, eval and train forward (port of
salience_detr_tpu/models/bricks/salience_transformer.py).

Hierarchical salience filtering encoder, two-stage proposal selection with
the grid-NMS kernel, and the box-refining decoder with look-forward-twice.
The static shapes of the JAX package are kept, so that its outputs can be
compared index for index: per-level token budgets come from the padded canvas
(``level_filter_ratio`` x static token counts), per-encoder-layer prefixes
from ``layer_filter_ratio``, and the two-stage NMS returns exactly
``min(num_queries, min(4 * num_queries, S))`` proposals with best-suppressed
backfill.  Every top-k goes through ``stable_topk``: padded tokens share one
minimum score and the JAX selections break such ties by lower index.

In training, the contrastive-denoising queries go in front of the matching
queries and the decoder's self-attention takes the CDN mask; gradients stop
where the JAX package stops them (the proposals fed to the decoder, each
layer's reference input and the refinement's input).

Token tensors are (B, S, C) in row-major y*w+x order per level, levels
concatenated; feature maps enter and leave the RepVGG neck as NCHW.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.attention import (
    MultiheadAttention,
    MultiScaleDeformableAttention,
)
from portbench.reference.layers import MLP, PerImageLinear
from portbench.reference.repnet import RepVGGPluXNetwork
from portbench.reference.misc import (
    device_constant,
    flatten_multi_level,
    inverse_sigmoid,
)
from portbench.reference.choices import grid_nms_topk, topk
from portbench.reference.pos_encoding import get_sine_pos_embed
from portbench.reference.misc import scope

LN_EPS = 1e-5


def _take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x (B, S, ...) gathered along dim 1 at index (B, K) -> (B, K, ...)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], index]


def bilinear_resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True of a channel-last map
    (B, h, w, C) -> (B, oh, ow, C), with the JAX package's arithmetic."""
    _, h, w, _ = x.shape
    oh, ow = out_hw

    def axis_coords(src, dst):
        if dst == 1:
            zero = torch.zeros(1, dtype=torch.long, device=x.device)
            return torch.zeros(1, device=x.device), zero, zero
        pos = torch.arange(dst, device=x.device) * ((src - 1) / (dst - 1))
        lo = torch.floor(pos).long().clamp(0, src - 1)
        hi = (lo + 1).clamp(0, src - 1)
        return pos - lo, lo, hi

    fy, y0, y1 = axis_coords(h, oh)
    fx, x0, x1 = axis_coords(w, ow)
    fx = fx[None, None, :, None]
    fy = fy[None, :, None, None]
    top = x[:, y0][:, :, x0] * (1 - fx) + x[:, y0][:, :, x1] * fx
    bot = x[:, y1][:, :, x0] * (1 - fx) + x[:, y1][:, :, x1] * fx
    return top * (1 - fy) + bot * fy


class MaskPredictor(nn.Module):
    """LN -> Linear -> GELU, local/global halves with a global token mean,
    then a 3-layer MLP to one salience logit per token."""

    def __init__(self, in_dim: int, h_dim: int):
        super().__init__()
        self.h_dim = h_dim
        self.layer1 = nn.Sequential(nn.LayerNorm(in_dim, eps=LN_EPS), nn.Linear(in_dim, h_dim), nn.GELU())
        self.layer2 = nn.Sequential(
            nn.Linear(h_dim, h_dim // 2), nn.GELU(),
            nn.Linear(h_dim // 2, h_dim // 4), nn.GELU(),
            PerImageLinear(h_dim // 4, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.layer1(x)
        z_local, z_global = z.split(self.h_dim // 2, dim=-1)
        z_global = z_global.mean(dim=1, keepdim=True).expand_as(z_global)
        return self.layer2(torch.cat([z_local, z_global], dim=-1))


class SalienceEncoderLayer(nn.Module):
    """Top-k dense pre-attention, deformable self-attention, FFN."""

    def __init__(self, embed_dim: int = 256, d_ffn: int = 2048, n_heads: int = 8,
                 n_levels: int = 4, n_points: int = 4, topk_sa: int = 300,
                 sampling_groups: int = 1):
        super().__init__()
        self.topk_sa = topk_sa
        self.site = "enc_pre"  # the selection's name; SalienceTransformer numbers it
        self.pre_attention = MultiheadAttention(embed_dim, n_heads)
        self.pre_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.self_attn = MultiScaleDeformableAttention(
            embed_dim, n_levels, n_heads, n_points, sampling_groups
        )
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.linear1 = nn.Linear(embed_dim, d_ffn)
        self.linear2 = nn.Linear(d_ffn, embed_dim)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, query, query_pos, value, reference_points, spatial_shapes,
                key_padding_mask, score_tgt, foreground_pre_layer):
        B, K, C = query.shape
        mc_score = score_tgt.max(-1).values * foreground_pre_layer
        _, sel = topk(self.site, mc_score, min(self.topk_sa, K))
        select_tgt = _take(query, sel)
        qk = select_tgt + _take(query_pos, sel)
        select_tgt = self.pre_norm(select_tgt + self.pre_attention(qk, qk, select_tgt))
        query = query.scatter(1, sel[..., None].expand(-1, -1, C), select_tgt.to(query.dtype))

        src2 = self.self_attn(
            query + query_pos, reference_points, value, spatial_shapes, key_padding_mask
        )
        query = self.norm1(query + src2)
        query = self.norm2(query + self.linear2(F.relu(self.linear1(query))))
        return query


class SalienceDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention, FFN."""

    def __init__(self, embed_dim: int = 256, d_ffn: int = 2048, n_heads: int = 8,
                 n_levels: int = 4, n_points: int = 4, sampling_groups: int = 8):
        super().__init__()
        self.self_attn = MultiheadAttention(embed_dim, n_heads)
        self.norm2 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.cross_attn = MultiScaleDeformableAttention(
            embed_dim, n_levels, n_heads, n_points, sampling_groups
        )
        self.norm1 = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.linear1 = nn.Linear(embed_dim, d_ffn)
        self.linear2 = nn.Linear(d_ffn, embed_dim)
        self.norm3 = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, query, query_pos, reference_points, value, spatial_shapes,
                key_padding_mask, attn_mask=None):
        qk = query + query_pos
        query = self.norm2(query + self.self_attn(qk, qk, query, attn_mask))
        q2 = self.cross_attn(
            query + query_pos, reference_points, value, spatial_shapes, key_padding_mask
        )
        query = self.norm1(query + q2)
        query = self.norm3(query + self.linear2(F.relu(self.linear1(query))))
        return query


class BackgroundEmbedding(nn.Module):
    """Learned row/column embedding for the non-foreground tokens."""

    def __init__(self, num_embeddings: int, num_pos_feats: int):
        super().__init__()
        self.row_embed = nn.Embedding(num_embeddings, num_pos_feats)
        self.col_embed = nn.Embedding(num_embeddings, num_pos_feats)

    def forward(self, spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """-> (S, 2 * num_pos_feats): [col_embed[x], row_embed[y]] per token."""
        embs = []
        for h, w in spatial_shapes:
            x_emb = self.col_embed.weight[:w]
            y_emb = self.row_embed.weight[:h]
            pos = torch.cat(
                [x_emb[None].expand(h, -1, -1), y_emb[:, None].expand(-1, w, -1)], dim=-1
            )
            embs.append(pos.reshape(h * w, -1))
        return torch.cat(embs, 0)


class SalienceEncoder(nn.Module):
    def __init__(self, layers: List[SalienceEncoderLayer], max_num_embedding: int, embed_dim: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.background_embedding = BackgroundEmbedding(max_num_embedding, embed_dim // 2)


class SalienceDecoder(nn.Module):
    def __init__(self, layers: List[SalienceDecoderLayer], embed_dim: int, num_classes: int):
        super().__init__()
        n = len(layers)
        self.layers = nn.ModuleList(layers)
        self.ref_point_head = MLP(2 * embed_dim, embed_dim, embed_dim, 2)
        self.class_head = nn.ModuleList(nn.Linear(embed_dim, num_classes) for _ in range(n))
        self.bbox_head = nn.ModuleList(MLP(embed_dim, embed_dim, 4, 3) for _ in range(n))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)


class SalienceTransformer(nn.Module):
    def __init__(
        self,
        num_classes: int,
        embed_dim: int = 256,
        num_encoder_layers: int = 6,
        num_decoder_layers: int = 6,
        num_heads: int = 8,
        d_ffn: int = 2048,
        num_feature_levels: int = 4,
        num_points: int = 4,
        topk_sa: int = 300,
        two_stage_num_proposals: int = 900,
        level_filter_ratio: Tuple[float, ...] = (0.4, 0.8, 1.0, 1.0),
        layer_filter_ratio: Tuple[float, ...] = (1.0, 0.8, 0.6, 0.6, 0.4, 0.2),
        max_num_embedding: int = 200,
        encoder_sampling_groups: int = 1,
        decoder_sampling_groups: int = 8,
    ):
        super().__init__()
        C, L = embed_dim, num_feature_levels
        self.embed_dim, self.num_classes = C, num_classes
        self.two_stage_num_proposals = two_stage_num_proposals
        self.level_filter_ratio = tuple(level_filter_ratio)
        self.layer_filter_ratio = tuple(layer_filter_ratio)
        self.level_embeds = nn.Parameter(torch.empty(L, C))
        self.alpha = nn.Parameter(torch.empty(3))
        self.tgt_embed = nn.Embedding(two_stage_num_proposals, C)
        self.enc_output = nn.Linear(C, C)
        self.enc_output_norm = nn.LayerNorm(C, eps=LN_EPS)
        self.encoder_class_head = nn.Linear(C, num_classes)
        self.encoder_bbox_head = MLP(C, C, 4, 3)
        self.enc_mask_predictor = MaskPredictor(C, C)
        self.encoder = SalienceEncoder(
            [
                SalienceEncoderLayer(C, d_ffn, num_heads, L, num_points, topk_sa,
                                     encoder_sampling_groups)
                for _ in range(num_encoder_layers)
            ],
            max_num_embedding, C,
        )
        for i, layer in enumerate(self.encoder.layers):
            layer.site = f"enc{i}_pre"
        self.neck = RepVGGPluXNetwork([C] * L, [C] * L, groups=4)
        self.decoder = SalienceDecoder(
            [
                SalienceDecoderLayer(C, d_ffn, num_heads, L, num_points, decoder_sampling_groups)
                for _ in range(num_decoder_layers)
            ],
            C, num_classes,
        )

    # ------------------------------------------------------------------ helpers

    def _gen_encoder_output_proposals(self, memory, mask_flatten, spatial_shapes, valid_hw):
        """Grid proposals per token (logit space, +inf where invalid) and the
        projected memory with padded / border tokens zeroed."""
        B = memory.shape[0]
        proposals = []
        for lvl, (h, w) in enumerate(spatial_shapes):
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=memory.device),
                torch.arange(w, dtype=torch.float32, device=memory.device),
                indexing="ij",
            )
            grid = torch.stack([gx, gy], -1)[None]  # (1, h, w, 2)
            scale = valid_hw[lvl].flip(-1).float()[:, None, None, :]  # (B, 1, 1, 2) = (w, h)
            grid = (grid + 0.5) / scale
            wh = torch.full_like(grid, 0.05 * 2.0**lvl)
            proposals.append(torch.cat([grid, wh], -1).reshape(B, h * w, 4))
        output_proposals = torch.cat(proposals, 1)
        valid = ((output_proposals > 0.01) & (output_proposals < 0.99)).all(-1, keepdim=True)
        p = output_proposals.clamp(1e-7, 1.0 - 1e-7)
        output_proposals = torch.log(p / (1 - p))
        invalid = mask_flatten[..., None] | ~valid
        output_proposals = output_proposals.masked_fill(invalid, float("inf"))
        output_memory = memory * (~mask_flatten[..., None]) * valid
        output_memory = self.enc_output_norm(self.enc_output(output_memory))
        return output_memory, output_proposals

    @staticmethod
    def _encoder_reference_points(spatial_shapes, valid_ratios):
        """(B, S, L, 2) grid reference points scaled by the valid ratios."""
        ref_list = []
        for lvl, (h, w) in enumerate(spatial_shapes):
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=valid_ratios.device) + 0.5,
                torch.arange(w, dtype=torch.float32, device=valid_ratios.device) + 0.5,
                indexing="ij",
            )
            ref_y = gy.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * h)
            ref_x = gx.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * w)
            ref_list.append(torch.stack([ref_x, ref_y], -1))
        ref = torch.cat(ref_list, 1)
        return ref[:, :, None] * valid_ratios[:, None]

    # ------------------------------------------------------------------ forward

    def forward(
        self,
        multi_level_feats: List[torch.Tensor],  # [(B, C, h, w)]
        multi_level_masks: List[torch.Tensor],  # [(B, h, w)] True = padding
        multi_level_pos: List[torch.Tensor],  # [(B, h, w, C)] channel-last
        valid_hw: List[torch.Tensor],  # [(B, 2)] valid (h, w) per level
        valid_ratios: torch.Tensor,  # (B, L, 2) (w, h) ratios
        noised_label_query: Optional[torch.Tensor] = None,  # (B, NDN, C) CDN, train only
        noised_box_query: Optional[torch.Tensor] = None,  # (B, NDN, 4) logits
        attn_mask: Optional[torch.Tensor] = None,  # (NDN + Q, NDN + Q) True = blocked
    ):
        spatial_shapes = [tuple(f.shape[-2:]) for f in multi_level_feats]
        level_sizes = [h * w for h, w in spatial_shapes]
        S = sum(level_sizes)
        starts = np.concatenate([[0], np.cumsum(level_sizes)]).tolist()
        B = multi_level_feats[0].shape[0]
        C = self.embed_dim
        L = len(spatial_shapes)

        with scope("flatten_inputs"):
            feat_flatten = torch.cat([f.flatten(2).transpose(1, 2) for f in multi_level_feats], 1)
            mask_flatten = flatten_multi_level(multi_level_masks)
            lvl_pos = flatten_multi_level(
                [p + self.level_embeds[i].to(p.dtype) for i, p in enumerate(multi_level_pos)]
            )
        with scope("backbone_memory_proj"):
            backbone_output_memory, _ = self._gen_encoder_output_proposals(
                feat_flatten + lvl_pos, mask_flatten, spatial_shapes, valid_hw
            )

        # static per-level budgets from the canvas; per-image focus counts
        level_token_nums = [max(int(sz * r), 1) for sz, r in zip(level_sizes, self.level_filter_ratio)]
        valid_token_nums = torch.stack([vh[:, 0] * vh[:, 1] for vh in valid_hw], -1)
        ratios = device_constant(self.level_filter_ratio, valid_ratios.device)
        focus_token_nums = (valid_token_nums.float() * ratios).int().sum(-1)  # (B,)

        # high -> low level salience cascade
        selected_score, selected_inds, salience_score = [], [], [None] * L
        score = None
        with scope("salience_cascade"):
            for level_idx in range(L - 1, -1, -1):
                h, w = spatial_shapes[level_idx]
                s0, s1 = starts[level_idx], starts[level_idx + 1]
                level_memory = backbone_output_memory[:, s0:s1]
                mask = mask_flatten[:, s0:s1]
                if level_idx != L - 1:
                    up = bilinear_resize_align_corners(score, (h, w)).reshape(B, h * w, 1)
                    level_memory = level_memory + level_memory * up * self.alpha[level_idx].to(level_memory.dtype)
                score_tok = self.enc_mask_predictor(level_memory)  # (B, hw, 1)
                valid_score = torch.where(mask, score_tok.min(), score_tok[..., 0])
                score = score_tok.reshape(B, h, w, 1)
                level_score, level_inds = topk(f"level{level_idx}", valid_score, min(level_token_nums[level_idx], h * w))
                selected_inds.append(level_inds + s0)
                selected_score.append(level_score)
                salience_score[level_idx] = score

        # global sort and per-layer prefixes
        with scope("salience_sort"):
            selected_score = torch.cat(selected_score[::-1], 1)
            selected_inds = torch.cat(selected_inds[::-1], 1)
            _, order = topk("global_sort", selected_score, selected_score.shape[1])
            selected_inds = selected_inds.gather(1, order)
            K = selected_inds.shape[1]
            layer_ks = [max(int(K * r), 1) for r in self.layer_filter_ratio]
            foreground_score = flatten_multi_level([s[..., 0] for s in salience_score])
            foreground_score = torch.where(mask_flatten, foreground_score.min(), foreground_score)

        # encoder: deformable attention samples the ORIGINAL feat_flatten in
        # every layer; updated memory is only seen through the gathered queries
        enc_ref_points = self._encoder_reference_points(spatial_shapes, valid_ratios).reshape(B, S, -1)
        output = feat_flatten
        last_inds = None
        for layer_id, layer in enumerate(self.encoder.layers):
            with scope(f"encoder_layer_{layer_id}"):
                inds = selected_inds[:, : layer_ks[layer_id]]
                upd = torch.arange(inds.shape[1], device=inds.device)[None] < focus_token_nums[:, None]
                last_inds = inds
                query = _take(output, inds)
                query_pos = _take(lvl_pos, inds)
                fg_pre = foreground_score.gather(1, inds)
                ref = _take(enc_ref_points, inds).reshape(B, -1, L, 2)
                score_tgt = self.encoder_class_head(query)
                query = layer(
                    query, query_pos, feat_flatten, ref, spatial_shapes, mask_flatten,
                    score_tgt, fg_pre,
                )
                merged = torch.where(upd[..., None], query.to(output.dtype), _take(output, inds))
                output = output.scatter(1, inds[..., None].expand(-1, -1, C), merged)

        # background embedding for the non-foreground tokens
        with scope("background_embed"):
            bg = self.encoder.background_embedding(spatial_shapes).to(output.dtype)
            bg = bg[None].expand(B, -1, -1).scatter(1, last_inds[..., None].expand(-1, -1, C), 0.0)
            memory = output + bg * (~mask_flatten[..., None])

        # RepVGG-PluX neck re-fusion on the 2D maps
        maps = [
            memory[:, starts[lvl]:starts[lvl + 1]].transpose(1, 2).reshape(B, C, h, w)
            for lvl, (h, w) in enumerate(spatial_shapes)
        ]
        memory = torch.cat([f.flatten(2).transpose(1, 2) for f in self.neck(maps)], 1)

        # two-stage proposals: top-4N tokens -> grid NMS -> N
        with scope("two_stage_heads"):
            output_memory, output_proposals = self._gen_encoder_output_proposals(
                memory, mask_flatten, spatial_shapes, valid_hw
            )
            enc_outputs_class = self.encoder_class_head(output_memory)
            enc_outputs_coord = (self.encoder_bbox_head(output_memory) + output_proposals).sigmoid()
        num_candidates = min(self.two_stage_num_proposals * 4, S)
        num_proposals = min(self.two_stage_num_proposals, num_candidates)
        with scope("proposal_topk"):
            _, topk_index = topk("proposal", enc_outputs_class.max(-1).values, num_candidates)
        with scope("proposal_nms"):
            nms_index = grid_nms_topk(
                topk_index.to(torch.int32).contiguous(), spatial_shapes, num_proposals
            ).long()
            enc_class = _take(enc_outputs_class, nms_index)
            enc_coord = _take(enc_outputs_coord, nms_index)

        target = self.tgt_embed.weight[None, :num_proposals].expand(B, -1, -1).to(memory.dtype)
        reference_points = enc_coord.detach()
        if noised_label_query is not None and noised_box_query is not None:
            target = torch.cat([noised_label_query.to(target.dtype), target], 1)
            reference_points = torch.cat([noised_box_query.sigmoid(), reference_points], 1)
        outputs_classes, outputs_coords = self._decode(
            target, reference_points, memory, mask_flatten, spatial_shapes, valid_ratios, attn_mask
        )
        return outputs_classes, outputs_coords, enc_class, enc_coord, salience_score, nms_index

    def _decode(self, query, reference_points, value, key_padding_mask, spatial_shapes,
                valid_ratios, attn_mask=None):
        """Decoder with look-forward-twice box refinement: each layer's box
        output keeps the gradient through the previous layer's refined
        reference, while the layer input and the next refinement see it
        detached."""
        dec = self.decoder
        outputs_classes, outputs_coords = [], []
        vr_scale = torch.cat([valid_ratios, valid_ratios], -1)[:, None]  # (B, 1, L, 4)
        for i, layer in enumerate(dec.layers):
            with scope(f"decoder_layer_{i}"):
                ref_in = reference_points.detach()[:, :, None] * vr_scale  # (B, Q, L, 4)
                query_sine = get_sine_pos_embed(ref_in[:, :, 0, :], num_pos_feats=self.embed_dim // 2)
                query_pos = dec.ref_point_head(query_sine.to(query.dtype))
                query = layer(
                    query, query_pos, ref_in, value, spatial_shapes, key_padding_mask, attn_mask
                )
                normed = dec.norm(query)
                outputs_classes.append(dec.class_head[i](normed))
                outputs_coords.append(
                    (dec.bbox_head[i](normed) + inverse_sigmoid(reference_points)).sigmoid()
                )
                if i == len(dec.layers) - 1:
                    break
                reference_points = (
                    dec.bbox_head[i](query) + inverse_sigmoid(reference_points.detach())
                ).sigmoid()
        return torch.stack(outputs_classes), torch.stack(outputs_coords)
