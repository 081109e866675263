"""K5 with the tail of each head's slice staged in a thread-block cluster's
shared memory (``gather_sum.cu`` in this directory): a design of the
shootout's gather-sum measured beside the shipped kernel
(``salience_detr_torch/csrc/gather_sum.cu``, wrapper
``ops/msda_stages.gather_sum``), which it does not replace.

* :func:`gather_stage` and :func:`gather_sum_smem_bytes` mirror the kernel's
  staging plan (``Stage::of``): rows a block holds, the TMA box height, the
  rows allocated, the block's dynamic shared memory;
* :func:`gather_sum_plan` sizes a launch: the tail T, the cluster size and
  the query ranges per (b, h);
* :func:`owner_and_row` is the kernel's exact division of a tail row among
  the cluster's blocks;
* :func:`gather_sum_staged` launches it on CUDA tensors (the library is built
  from this directory on first use) and raises when the card refuses.

Its function is :func:`salience_detr_torch.ops.msda_stages.gather_sum_plain`;
``chip_smoke.py --baseline-csrc salience_detr_torch/tools/gather_cluster``
times it in turns with the shipped kernel (``gather_ab:``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from salience_detr_torch import native

SOURCE_DIR = Path(__file__).resolve().parent
# a block's dynamic shared memory: an mbarrier's 128 bytes, then its rows of
# the tail (64 B each) in whole TMA boxes of up to 256 rows; at the opt-in
# 227 KB of an sm_90 card that is 14 boxes, 3,584 rows
STAGE_OFFSET = 128
BOX_ROWS = 256
ROW_BYTES = 64
BLOCK_ROWS = 3584
MAX_CLUSTER = 8
SMEM_OPTIN_BYTES = 232448

_lib: Optional[ctypes.CDLL] = None


def gather_stage(T: int, cluster: int) -> Tuple[int, int, int]:
    """(rows a block holds, TMA box height, rows allocated) for a tail of T
    rows over ``cluster`` blocks: the box is even, so that every box starts
    128-byte aligned, and the allocation is whole boxes."""
    rows = -(-T // cluster) if T > 0 else 0
    box = BOX_ROWS if rows >= BOX_ROWS else (rows + 1) // 2 * 2
    alloc = -(-rows // box) * box if box else 0
    return rows, box, alloc


def gather_sum_smem_bytes(T: int, cluster: int) -> int:
    return STAGE_OFFSET + gather_stage(T, cluster)[2] * ROW_BYTES


def magic(rows: int) -> int:
    """ceil(2^32 / rows): the kernel's multiplier for t // rows."""
    return ((1 << 32) + rows - 1) // rows


def owner_and_row(t: int, rows: int) -> Tuple[int, int]:
    """Tail row t's block and row within it, as the kernel computes them:
    (t * magic(rows)) >> 32, exact while t * rows <= 2^32."""
    owner = (t * magic(rows)) >> 32
    return owner, t - owner * rows


def gather_sum_plan(B: int, S: int, H: int, Q: int, cluster: int = 1, block_rows: int = BLOCK_ROWS,
                    sms: int = 132) -> Tuple[int, int, int]:
    """(T, cluster, qsplit): the tail ``cluster`` blocks of ``block_rows``
    rows hold (capped at S), and as many query ranges per (b, h) as put one
    block on each of ``sms`` SMs (1024 threads take an SM's registers)."""
    T = min(S, cluster * block_rows)
    qsplit = max(1, min(max(Q, 1), sms // max(1, B * H * cluster)))
    return T, cluster, qsplit


def load() -> ctypes.CDLL:
    """This directory's library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native.build(SOURCE_DIR)))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gather_sum_staged.argtypes = [ptr, ptr, ptr] + [i32] * 9 + [ptr]
        lib.gather_sum_staged.restype = i32
        _lib = lib
    return _lib


def gather_sum_staged(value: torch.Tensor, idx: torch.Tensor, T: int, cluster: int, qsplit: int) -> torch.Tensor:
    """One launch on CUDA tensors: value a contiguous bf16 (B, S, H, 32)
    tensor, 16-byte aligned, idx a contiguous int32 (B, H, Q, G) tensor, the
    last T rows of each head's slice staged across ``cluster`` blocks and
    ``qsplit`` query ranges per (b, h).  An index outside [0, S) adds
    nothing."""
    if value.device.type != "cuda" or idx.device != value.device:
        raise RuntimeError(f"gather_sum_staged: no kernel for device {value.device}")
    if value.dtype != torch.bfloat16 or idx.dtype != torch.int32:
        raise TypeError(f"gather_sum_staged: value bf16 and idx int32, got {value.dtype}, {idx.dtype}")
    if (value.dim() != 4 or idx.dim() != 4 or idx.shape[:2] != (value.shape[0], value.shape[2])
            or not value.is_contiguous() or not idx.is_contiguous() or value.data_ptr() % 16):
        raise ValueError(f"gather_sum_staged: value (B,S,H,D) {tuple(value.shape)} and idx (B,H,Q,G) "
                         f"{tuple(idx.shape)}, contiguous, value 16-byte aligned")
    B, S, H, D = value.shape
    Q, G = idx.shape[2:]
    if D != 32:
        raise ValueError(f"gather_sum_staged: the kernel takes D=32, got D={D}")
    if not (0 <= T <= S and 1 <= cluster <= MAX_CLUSTER and qsplit >= 1
            and gather_sum_smem_bytes(T, cluster) <= SMEM_OPTIN_BYTES):
        raise ValueError(f"gather_sum_staged: T={T} (S={S}), cluster={cluster}, qsplit={qsplit} not taken")
    out = torch.empty((B, H, Q, D), dtype=value.dtype, device=value.device)
    if out.numel():
        with torch.cuda.device(value.device):
            err = load().gather_sum_staged(value.data_ptr(), idx.data_ptr(), out.data_ptr(), B, S, H, D, Q, G,
                                           T, cluster, qsplit, native.stream_of(value))
        native.check(err, f"gather_sum_staged (T {T}, cluster {cluster}, qsplit {qsplit})")
    return out
