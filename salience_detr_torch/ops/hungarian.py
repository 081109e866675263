"""Batched exact linear-sum assignment (port of salience_detr_tpu/ops/hungarian.py).

Convention as in the JAX package: cost (B, N queries, M gts); every valid gt
column is assigned a distinct query row; the result is (B, M) int32, the
matched query per gt and -1 for padded gts.

* :func:`batched_assignment_plain` is the plain PyTorch version, a torch-ops
  twin of the JAX package's successive shortest augmenting paths with
  Bellman-Ford relaxation, batched; each relaxation round's convergence test
  synchronises with the host;
* :func:`batched_assignment` is the wrapper of the CUDA kernel
  ``csrc/hungarian.cu`` (shortest augmenting paths with potentials, one CTA
  per image, all images in one launch): a CPU tensor goes to the plain
  version, a CUDA tensor launches the kernel or raises.

Both are exact, so they agree wherever the optimum is unique and otherwise
reach the same total cost.
"""

from __future__ import annotations

import torch

from salience_detr_torch import native

# queries the kernel takes: 32 columns per thread of its 256
MAX_QUERIES = 8192
_INF = 1e15
# improvements below this are f32 ties; keeps the fixpoint from livelocking
_TOL = 1e-6


def batched_assignment_plain(cost: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """cost (B, N, M), gt_valid (B, M) bool -> (B, M) int32.

    One augmentation per gt column k, in order: Bellman-Ford from column k
    over paths that alternate through matched gts, then the path to the
    nearest unmatched query is flipped.  Images whose column k is padded
    compute and discard."""
    cost = cost.float()
    B, N, M = cost.shape
    device = cost.device
    batch = torch.arange(B, device=device)
    gt_ids = torch.arange(M, device=device)
    match_gt = torch.full((B, M), -1, dtype=torch.long, device=device)
    match_q = torch.full((B, N), -1, dtype=torch.long, device=device)
    for k in range(M):
        active = gt_valid[:, k]
        d = cost[:, :, k].clone()
        parent = torch.full((B, N), -1, dtype=torch.long, device=device)
        for _ in range(M + 1):
            matched = match_gt >= 0
            mq = torch.where(matched, match_gt, 0)
            # cost of reaching gt i through its matched query, then on to q
            reach = d.gather(1, mq) - cost[batch[:, None], mq, gt_ids]
            val = torch.where(matched, reach, torch.full_like(reach, _INF))
            cand = val[:, None, :] + cost  # (B, N, M)
            best, best_g = cand.min(2).values, cand.argmin(2)
            improve = best < d - _TOL
            d = torch.where(improve, best, d)
            parent = torch.where(improve, best_g, parent)
            if not bool(improve.any()):
                break
        q = torch.where(match_q < 0, d, torch.full_like(d, _INF)).argmin(1)
        done = ~active
        # a path visits at most k matched gts before the source column k
        for _ in range(k + 1):
            g = parent.gather(1, q[:, None])[:, 0]
            is_src = g < 0
            g_eff = torch.where(is_src, torch.full_like(g, k), g)
            prev = match_gt.gather(1, g_eff[:, None])[:, 0]
            live = (~done)[:, None]
            match_gt = torch.where(live, match_gt.scatter(1, g_eff[:, None], q[:, None]), match_gt)
            match_q = torch.where(live, match_q.scatter(1, q[:, None], g_eff[:, None]), match_q)
            done = done | is_src
            q = torch.where(done, q, prev)
    return match_gt.to(torch.int32)


def batched_assignment(cost: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """Wrapper of the assignment kernel (csrc/hungarian.cu); same contract as
    :func:`batched_assignment_plain`.  On CUDA it takes M <= N <= 8192."""
    if cost.device.type == "cpu":
        return batched_assignment_plain(cost, gt_valid)
    if cost.device.type != "cuda":
        raise RuntimeError(f"batched_assignment: no kernel for device {cost.device}")
    if cost.dim() != 3 or tuple(gt_valid.shape) != (cost.shape[0], cost.shape[2]):
        raise ValueError(
            f"batched_assignment: cost (B, N, M) and gt_valid (B, M) expected, got "
            f"{tuple(cost.shape)} and {tuple(gt_valid.shape)}"
        )
    B, N, M = cost.shape
    if not M <= N <= MAX_QUERIES:
        raise ValueError(f"batched_assignment: need gt slots ({M}) <= queries ({N}) <= {MAX_QUERIES}")
    if gt_valid.device != cost.device:
        raise ValueError("batched_assignment: cost and gt_valid must be on one device")
    # one gt's costs contiguous, each row a multiple of 16 bytes for the
    # kernel's bulk copies: the criterion's costs come so, others are copied
    cost_t = cost.transpose(1, 2)
    ld = -(-N // 4) * 4
    if cost_t.dtype != torch.float32 or ld != N or not cost_t.is_contiguous():
        cost_t = torch.zeros((B, M, ld), dtype=torch.float32, device=cost.device)
        cost_t[..., :N] = cost.transpose(1, 2)
    valid = gt_valid.to(torch.bool).contiguous().view(torch.uint8)
    out = torch.empty((B, M), dtype=torch.int32, device=cost.device)
    lib = native.load()
    with torch.cuda.device(cost.device):
        err = lib.assignment_forward(
            cost_t.data_ptr(), valid.data_ptr(), out.data_ptr(), B, N, M, ld,
            native.stream_of(cost),
        )
    native.check(err, "assignment_forward")
    native.LAUNCHES["hungarian"] += 1
    return out
