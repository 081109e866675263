"""Non-maximum suppression (port of salience_detr_tpu/ops/nms.py).

Grid NMS over the two-stage proposal tokens (``grid_nms_topk``): the
reference's NMS (IoU 0.3) on 2x2 boxes centred on feature-grid cells
suppresses exactly the 4-neighbours on the same level, so greedy NMS over the
score-ordered top-K tokens reduces to: keep a candidate iff no higher-ranked
kept candidate is its 4-neighbour.  The result holds the first ``num_out``
survivors in rank order, then the best-ranked suppressed candidates.

* :func:`grid_nms_topk_plain` is the plain PyTorch version, the JAX package's
  dense-rank-map fixpoint, batched; it runs on any device;
* :func:`grid_nms_topk` is the wrapper of the CUDA kernel
  ``csrc/grid_nms.cu`` (the same fixpoint in parallel rounds on the card, one
  block per image): a CPU tensor goes to the plain version, a CUDA tensor
  launches the kernel or raises.  Levels whose rank map does not fit the
  kernel's shared memory beside the candidates (13K + 2S + 1 bytes) go to
  the kernel's variant that keeps the map in a global scratch buffer.

Greedy NMS over score-ordered boxes (``nms_keep_mask``), the post-process
filter: a box is kept iff no better-ranked kept box has an IoU above the
threshold with it.

* :func:`nms_keep_mask_plain` is the JAX package's dense conflict-matrix
  fixpoint, batched;
* :func:`nms_keep_mask` is the wrapper of ``csrc/nms_keep.cu`` (a bitmask and
  a serial walk, one block per image), dispatching as ``grid_nms_topk`` does;
  above ``NMS_KEEP_SHARED_MAX_BOXES`` boxes the kernel's variant with the
  bitmask in a global scratch buffer takes any count.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from salience_detr_torch import native
from salience_detr_torch.ops.boxes import box_iou_pairwise

# dynamic shared memory the kernel may use (13K + 2S + 1 bytes), and the
# candidates its 16-bit rank map can hold
SMEM_BUDGET_BYTES = 226 * 1024
MAX_CANDIDATES = 65535
# relaxation steps of the plain fixpoints between convergence checks
UNROLL = 8
# boxes per image the keep-mask kernel takes with its bitmask in shared
# memory (its walking warp holds one 32-bit removed-mask word per lane);
# more go to the variant with the bitmask in global memory
NMS_KEEP_SHARED_MAX_BOXES = 1024


def grid_nms_rank_in_global(K: int, S: int) -> bool:
    """Whether the grid-NMS kernel keeps its rank map in global memory: when
    13K + 2S + 1 bytes exceed its shared memory."""
    return 13 * K + 2 * S + 1 > SMEM_BUDGET_BYTES


def _shift2d(arr: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., i, j] = arr[..., i - dy, j - dx], ``fill`` outside."""
    h, w = arr.shape[-2:]
    pad = (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0))
    padded = F.pad(arr, pad, value=fill)
    return padded[..., max(-dy, 0):max(-dy, 0) + h, max(-dx, 0):max(-dx, 0) + w]


def grid_nms_topk_plain(
    topk_index: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    num_out: int,
) -> torch.Tensor:
    """topk_index (B, K) integer token indices in descending score order ->
    (B, num_out) int32.

    Each relaxation step recomputes keep[i] = no 4-neighbour on the level with
    a lower rank is kept, over dense per-level rank maps (tokens that are not
    candidates hold rank K and never suppress); ``UNROLL`` steps run between
    convergence checks, each of which synchronises with the host.
    """
    B, K = topk_index.shape
    device = topk_index.device
    sizes = [h * w for h, w in spatial_shapes]
    total = sum(sizes)
    index = topk_index.long()
    rank_flat = torch.full((B, total), K, dtype=torch.int32, device=device)
    rank_flat.scatter_(
        1, index, torch.arange(K, dtype=torch.int32, device=device).expand(B, K).contiguous()
    )
    rank_maps = [
        r.reshape(B, h, w) for r, (h, w) in zip(rank_flat.split(sizes, 1), spatial_shapes)
    ]
    # shifted neighbour ranks do not change between steps
    neighbour_ranks = [
        [_shift2d(r, dy, dx, K) for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0))]
        for r in rank_maps
    ]

    def conflict_with_higher(keep_flat):
        outs = []
        for (h, w), r, nbs, k2 in zip(
            spatial_shapes, rank_maps, neighbour_ranks, keep_flat.split(sizes, 1)
        ):
            k2 = k2.reshape(B, h, w)
            conflict = torch.zeros_like(k2)
            for (dy, dx), nb_r in zip(((0, 1), (0, -1), (1, 0), (-1, 0)), nbs):
                conflict |= _shift2d(k2, dy, dx, False) & (nb_r < r)
            outs.append(conflict.reshape(B, -1))
        return torch.cat(outs, 1)

    keep = torch.ones((B, total), dtype=torch.bool, device=device)
    for _ in range(0, total + UNROLL, UNROLL):
        prev = keep
        for _ in range(UNROLL):
            keep = ~conflict_with_higher(keep)
        if torch.equal(keep, prev):
            break
    keep_c = keep.gather(1, index)  # (B, K) in rank order
    sort_key = torch.arange(K, device=device) + torch.where(keep_c, 0, K)
    order = torch.argsort(sort_key, dim=1)
    return index.gather(1, order[:, :num_out]).to(torch.int32)


def grid_nms_topk(
    topk_index: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    num_out: int,
) -> torch.Tensor:
    """Wrapper of the grid-NMS kernel (csrc/grid_nms.cu); same contract as
    :func:`grid_nms_topk_plain`.  On CUDA, ``topk_index`` must be a
    contiguous (B, K) int32 tensor of unique indices in [0, S), with 13K + 1
    <= ``SMEM_BUDGET_BYTES`` (K up to 17,801)."""
    if topk_index.device.type == "cpu":
        return grid_nms_topk_plain(topk_index, spatial_shapes, num_out)
    if topk_index.device.type != "cuda":
        raise RuntimeError(f"grid_nms_topk: no kernel for device {topk_index.device}")
    if topk_index.dtype != torch.int32 or topk_index.dim() != 2 or not topk_index.is_contiguous():
        raise TypeError(
            "grid_nms_topk: topk_index must be a contiguous (B, K) int32 tensor, got "
            f"{topk_index.dtype} {tuple(topk_index.shape)}"
        )
    B, K = topk_index.shape
    S = sum(h * w for h, w in spatial_shapes)
    if not 0 <= num_out <= K <= MAX_CANDIDATES or 13 * K + 1 > SMEM_BUDGET_BYTES:
        raise ValueError(
            f"grid_nms_topk: need 0 <= num_out <= K <= {MAX_CANDIDATES} and 13K + 1 <= "
            f"{SMEM_BUDGET_BYTES}; got num_out={num_out}, K={K}, S={S}"
        )
    out = torch.empty((B, num_out), dtype=torch.int32, device=topk_index.device)
    lib = native.load()
    levels = native.level_table(spatial_shapes)
    stream = native.stream_of(topk_index)
    with torch.cuda.device(topk_index.device):
        if grid_nms_rank_in_global(K, S):
            # the 16-bit rank map, B x S (the kernel writes it before reading)
            ranks = torch.empty((B, S), dtype=torch.int16, device=topk_index.device)
            err = lib.grid_nms_forward_global(topk_index.data_ptr(), levels, out.data_ptr(), ranks.data_ptr(),
                                              B, K, num_out, stream)
        else:
            err = lib.grid_nms_forward(topk_index.data_ptr(), levels, out.data_ptr(), B, K, num_out, stream)
    native.check(err, "grid_nms_forward")
    native.LAUNCHES["grid_nms"] += 1
    return out


def nms_keep_mask_plain(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """boxes (B, N, 4) xyxy in descending score order -> (B, N) bool keep
    mask, the exact greedy result.

    The dense conflict matrix holds iou(i, j) > threshold (float32) for every
    better-ranked j < i; each relaxation step recomputes keep[i] = no
    conflicting j is kept, ``UNROLL`` steps between convergence checks, each
    of which synchronises with the host.
    """
    B, N, _ = boxes.shape
    iou, _ = box_iou_pairwise(boxes, boxes)
    rank = torch.arange(N, device=boxes.device)
    conflict = (iou > float(np.float32(iou_threshold))) & (rank[None, :] < rank[:, None])
    keep = torch.ones((B, N), dtype=torch.bool, device=boxes.device)
    for _ in range(0, N + UNROLL, UNROLL):
        prev = keep
        for _ in range(UNROLL):
            keep = ~(conflict & keep[:, None, :]).any(-1)
        if torch.equal(keep, prev):
            break
    return keep


def nms_keep_mask(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Wrapper of the keep-mask kernel (csrc/nms_keep.cu); same contract as
    :func:`nms_keep_mask_plain`.  On CUDA, ``boxes`` must be a contiguous
    (B, N, 4) float32 tensor; above ``NMS_KEEP_SHARED_MAX_BOXES`` boxes the
    kernel keeps its N x ceil(N/32)-word bitmask in a scratch buffer of
    global memory."""
    if boxes.device.type == "cpu":
        return nms_keep_mask_plain(boxes, iou_threshold)
    if boxes.device.type != "cuda":
        raise RuntimeError(f"nms_keep_mask: no kernel for device {boxes.device}")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[-1] != 4 or not boxes.is_contiguous():
        raise TypeError(
            "nms_keep_mask: boxes must be a contiguous (B, N, 4) float32 tensor, got "
            f"{boxes.dtype} {tuple(boxes.shape)}"
        )
    B, N, _ = boxes.shape
    keep = torch.empty((B, N), dtype=torch.bool, device=boxes.device)
    if B == 0 or N == 0:
        return keep
    lib = native.load()
    threshold, stream = float(np.float32(iou_threshold)), native.stream_of(boxes)
    with torch.cuda.device(boxes.device):
        if N > NMS_KEEP_SHARED_MAX_BOXES:
            mask = torch.empty((B, N, (N + 31) // 32), dtype=torch.int32, device=boxes.device)
            err = lib.nms_keep_forward_global(boxes.data_ptr(), threshold, keep.data_ptr(), mask.data_ptr(), B, N,
                                              stream)
        else:
            err = lib.nms_keep_forward(boxes.data_ptr(), threshold, keep.data_ptr(), B, N, stream)
    native.check(err, "nms_keep_forward")
    native.LAUNCHES["nms_keep"] += 1
    return keep
