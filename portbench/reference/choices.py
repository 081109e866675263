"""The reference's discrete choices: every top-k, the two-stage grid NMS and
the Hungarian assignment go through here, each under a site name.

``Choices`` has three modes:

* ``free``: the reference's own choices (a stable descending sort; the grid
  NMS and an exact assignment, ``scipy.optimize.linear_sum_assignment``);
* ``record``: the same, and each choice kept, in the order made, as
  ``(kind, index)`` (the control, the reference in a lower precision,
  records its choices as the program's are recorded);
* ``force``: the choices of another run, ``[(kind, index)]`` in the order
  that run made them, each judged against the reference's own scores first.
  A site takes the next choice of its kind (``topk``, ``nms``, ``post``,
  ``assign``) of the shape it needs, after the last one taken; where none
  is left, the reference makes its own choice there and the site is noted
  in ``unforced``, so that a program which fuses, renames or drops a
  choice is judged by its outputs alone.
  A top-k's gap is the worst inversion of the forced order under the
  reference's float32 scores, with every candidate left out placed after
  the last one taken: max over j of (s[f_j] - min over i < j of s[f_i]),
  over the standard deviation of the row's scores.  The grid NMS counts
  the images where the reference's NMS over the forced candidates keeps
  other proposals than the forced result.  The assignment's gap is what the
  forced assignment costs beyond the optimal one under the reference's
  costs, per gt, over the standard deviation of the cost matrix.

With random weights the scores of a top-k lie closer together than the
program's bfloat16 rounding, so the order differs from float32's by design;
judged so, a near-tie costs a small gap and a wrong choice a large one.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.misc import stable_topk


Record = Tuple[str, torch.Tensor]  # (kind, index)


def kind_of(site: str) -> str:
    """The kind of choice a site makes: ``nms``, ``post`` (the
    post-process's top-k), ``assign`` or ``topk`` (the transformer's)."""
    if site.startswith("assign"):
        return "assign"
    return site if site in ("nms", "post") else "topk"


class Choices:
    def __init__(self, mode: str = "free", forced: Optional[List[Record]] = None):
        assert mode in ("free", "record", "force"), mode
        self.mode, self.forced = mode, list(forced or [])
        self.records: List[Record] = []
        self.recorded: set = set()  # sites recorded (a checkpointed block runs its sites twice)
        self.taken: Dict[str, int] = {}  # kind -> position in ``forced`` after the last one taken
        self.resolved: Dict[str, Optional[torch.Tensor]] = {}  # site -> its forced choice, once found
        self.unforced: List[str] = []  # sites with no forced choice of their kind and shape left
        self.gaps: Dict[str, float] = {}  # site -> worst gap (top-k, assignment)
        self.nms_mismatch = 0  # images whose NMS differs from the forced one
        self.assignments = 0  # assignment calls so far (their sites: assign, assign1, ...)

    def record(self, site: str, index: torch.Tensor) -> None:
        if self.mode == "record" and site not in self.recorded:
            self.recorded.add(site)
            self.records.append((kind_of(site), index.detach()))


_ACTIVE = [Choices("free")]


@contextlib.contextmanager
def choices(c: Choices):
    _ACTIVE.append(c)
    try:
        yield c
    finally:
        _ACTIVE.pop()


def _current() -> Choices:
    return _ACTIVE[-1]


def _forced(c: Choices, site: str, like_shape) -> Optional[torch.Tensor]:
    """The forced choice of ``site``: the next one of its kind and of shape
    ``like_shape`` after the last one of that kind taken; None (the site
    noted in ``unforced``, the reference then making its own choice) where
    the other run made none such.  A site asked again (a checkpointed block
    run again for the backward) gets the same answer."""
    if site in c.resolved:
        return c.resolved[site]
    kind = kind_of(site)
    found = None
    for pos in range(c.taken.get(kind, 0), len(c.forced)):
        k, idx = c.forced[pos]
        if k == kind and tuple(idx.shape) == tuple(like_shape):
            c.taken[kind] = pos + 1
            found = idx
            break
    if found is None:
        c.unforced.append(site)
    c.resolved[site] = found
    return found


def order_gap(scores: torch.Tensor, idx: torch.Tensor) -> float:
    """Worst inversion of the order ``idx`` (B, k) under ``scores`` (B, N),
    the candidates not in ``idx`` after the last; in standard deviations of
    each row's scores."""
    s = scores.detach().float()
    taken = s.gather(1, idx)
    prefix_min = torch.cummin(taken, 1).values
    inversion = (taken[:, 1:] - prefix_min[:, :-1]).amax(1) if taken.shape[1] > 1 else torch.zeros(s.shape[0], device=s.device)
    rest = s.scatter(1, idx, float("-inf")).amax(1) if idx.shape[1] < s.shape[1] else torch.full_like(inversion, float("-inf"))
    gap = torch.maximum(inversion, rest - prefix_min[:, -1]).clamp(min=0.0)
    spread = s.std(1).clamp(min=1e-12)
    return float((gap / spread).max())


def _note(c: Choices, site: str, gap: float) -> None:
    c.gaps[site] = max(c.gaps.get(site, 0.0), gap)


def topk(site: str, scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k best of ``scores`` (B, N) along the last
    dim, descending, ties to the lower index."""
    c = _current()
    if c.mode != "force":
        values, index = stable_topk(scores, k)
        c.record(site, index)
        return values, index
    index = _forced(c, site, (*scores.shape[:-1], k))
    if index is None:
        return stable_topk(scores, k)
    index = index.to(scores.device).long()
    _note(c, site, order_gap(scores, index))
    return scores.gather(-1, index), index


# ------------------------------------------------------------- grid NMS

def _shift2d(arr: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., i, j] = arr[..., i - dy, j - dx], ``fill`` outside."""
    h, w = arr.shape[-2:]
    pad = (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0))
    padded = F.pad(arr, pad, value=fill)
    return padded[..., max(-dy, 0):max(-dy, 0) + h, max(-dx, 0):max(-dx, 0) + w]


def grid_nms_plain(topk_index: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   num_out: int) -> torch.Tensor:
    """topk_index (B, K) token indices in descending score order -> (B,
    num_out): the candidates kept by greedy NMS, in rank order, where a token
    suppresses its 4-neighbours on its level of lower rank; suppressed ones
    fill up the rest in rank order.  Greedy NMS is the fixpoint of
    keep[i] = no kept 4-neighbour of lower rank, iterated to convergence."""
    B, K = topk_index.shape
    device = topk_index.device
    sizes = [h * w for h, w in spatial_shapes]
    index = topk_index.long()
    rank = torch.full((B, sum(sizes)), K, dtype=torch.int64, device=device)
    rank.scatter_(1, index, torch.arange(K, device=device).expand(B, K).contiguous())
    maps = [r.reshape(B, h, w) for r, (h, w) in zip(rank.split(sizes, 1), spatial_shapes)]
    shifts = ((0, 1), (0, -1), (1, 0), (-1, 0))
    neighbours = [[_shift2d(r, dy, dx, K) for dy, dx in shifts] for r in maps]
    keep = torch.ones((B, sum(sizes)), dtype=torch.bool, device=device)
    while True:
        parts = []
        for (h, w), r, nbs, k2 in zip(spatial_shapes, maps, neighbours, keep.split(sizes, 1)):
            k2 = k2.reshape(B, h, w)
            conflict = torch.zeros_like(k2)
            for (dy, dx), nb in zip(shifts, nbs):
                conflict |= _shift2d(k2, dy, dx, False) & (nb < r)
            parts.append(~conflict.reshape(B, -1))
        new = torch.cat(parts, 1)
        if torch.equal(new, keep):
            break
        keep = new
    kept = keep.gather(1, index)
    order = torch.argsort(torch.arange(K, device=device) + torch.where(kept, 0, K), dim=1)
    return index.gather(1, order[:, :num_out])


def grid_nms_topk(topk_index: torch.Tensor, spatial_shapes, num_out: int) -> torch.Tensor:
    c = _current()
    own = grid_nms_plain(topk_index, spatial_shapes, num_out)
    c.record("nms", own)
    if c.mode != "force":
        return own
    forced = _forced(c, "nms", own.shape)
    if forced is None:
        return own
    forced = forced.to(own.device).long()
    c.nms_mismatch += int((forced != own).any(1).sum())
    return forced


# ------------------------------------------------------------- assignment

def _optimal(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """(B, Q, M) costs -> (B, M) query per valid gt (-1 for padded gts)."""
    from scipy.optimize import linear_sum_assignment

    B, Q, M = cost.shape
    out = np.full((B, M), -1, np.int64)
    for b in range(B):
        cols = np.flatnonzero(valid[b])
        if cols.size:
            rows, picked = linear_sum_assignment(cost[b][:, cols])
            out[b, cols[picked]] = rows
    return out


def assign(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """cost (B, Q, M), valid (B, M) -> (B, M) matched query per gt, -1 for a
    padded gt."""
    c = _current()
    site = "assign" if c.assignments == 0 else f"assign{c.assignments}"
    c.assignments += 1
    cost_np = cost.detach().float().cpu().numpy()
    valid_np = valid.cpu().numpy()
    if c.mode != "force":
        out = torch.from_numpy(_optimal(cost_np, valid_np)).to(cost.device)
        c.record(site, out)
        return out
    best = _optimal(cost_np, valid_np)
    forced = _forced(c, site, valid.shape)
    if forced is None:
        return torch.from_numpy(best).to(cost.device)
    forced = forced.to(cost.device).long()
    f = forced.cpu().numpy()
    gap = 0.0
    for b in range(cost_np.shape[0]):
        cols = np.flatnonzero(valid_np[b])
        if cols.size:
            extra = cost_np[b][f[b, cols], cols].sum() - cost_np[b][best[b, cols], cols].sum()
            gap = max(gap, float(extra) / cols.size / max(float(cost_np[b].std()), 1e-12))
        if len(set(f[b, cols].tolist())) != cols.size:
            gap = float("inf")  # a query matched twice is no assignment
    _note(c, site, gap)
    return forced
