"""Grid NMS over the two-stage proposal tokens (port of salience_detr_tpu/ops/nms.py::grid_nms_topk).

The reference's NMS (IoU 0.3) on 2x2 boxes centred on feature-grid cells
suppresses exactly the 4-neighbours on the same level, so greedy NMS over the
score-ordered top-K tokens reduces to: keep a candidate iff no higher-ranked
kept candidate is its 4-neighbour.  The result holds the first ``num_out``
survivors in rank order, then the best-ranked suppressed candidates.

* :func:`grid_nms_topk_plain` is the plain PyTorch version, the JAX package's
  dense-rank-map fixpoint, batched; it runs on any device;
* :func:`grid_nms_topk` is the wrapper of the CUDA kernel
  ``csrc/grid_nms.cu`` (the same fixpoint in parallel rounds on the card, one
  block per image): a CPU tensor goes to the plain version, a CUDA tensor
  launches the kernel or raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from salience_detr_torch import native

# dynamic shared memory the kernel may use (13K + 2S + 1 bytes), and the
# candidates its 16-bit rank map can hold
SMEM_BUDGET_BYTES = 226 * 1024
MAX_CANDIDATES = 65535
# relaxation steps of the plain fixpoint between convergence checks
UNROLL = 8


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
    contiguous (B, K) int32 tensor of unique indices in [0, S)."""
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
    if not 0 <= num_out <= K <= MAX_CANDIDATES or 13 * K + 2 * S + 1 > SMEM_BUDGET_BYTES:
        raise ValueError(
            f"grid_nms_topk: need 0 <= num_out <= K <= {MAX_CANDIDATES} and 13K + 2S + 1 <= "
            f"{SMEM_BUDGET_BYTES}; got num_out={num_out}, K={K}, S={S}"
        )
    out = torch.empty((B, num_out), dtype=torch.int32, device=topk_index.device)
    lib = native.load()
    with torch.cuda.device(topk_index.device):
        err = lib.grid_nms_forward(
            topk_index.data_ptr(), native.level_table(spatial_shapes), out.data_ptr(),
            B, K, num_out, native.stream_of(topk_index),
        )
    native.check(err, "grid_nms_forward")
    native.LAUNCHES["grid_nms"] += 1
    return out
