"""Build and load the port's CUDA kernels and its host C++ helper.

``csrc/*.cu`` compile with ``nvcc``, one process per source in parallel, into
one shared library with a plain C interface,
``build/salience_detr_torch/<source-hash>/libkernels.so`` under the
repository root, on first use; the library is loaded with ``ctypes``.  Every
pointer and the stream are passed as ``c_void_p``; the stream is PyTorch's
current stream.  Each C entry point returns ``cudaGetLastError()`` after its
launch, and :func:`check` raises when that is not 0.  A failed build raises
with nvcc's stderr.  Nothing here runs at import time.

``LAUNCHES`` counts kernel launches per kernel; each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "salience_detr_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
MAX_LEVELS = 16  # kLevelsMax in csrc/levels.cuh
# the C entry points' element-type codes (kFloat32, kBFloat16, kFloat16 in
# csrc/msda_common.cuh), for the DCN and int8 MSDA kernels
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

LAUNCHES = {
    "msda": 0, "msda_backward": 0, "msda_backward_ordered": 0, "grid_nms": 0, "hungarian": 0, "nms_keep": 0,
    # DCNv2 (ops/deform_conv.py: the columns, their backward, the fused 16-bit
    # forward) and the int8 head-shared MSDA
    "deform_conv": 0, "deform_conv_backward": 0, "deform_conv_fused": 0,
    "msda_q8_quantize": 0, "msda_q8_sample": 0,
    # the stage kernels of the MSDA shootout (ops/msda_stages.py)
    "gather_sum": 0, "weighted_reduce": 0, "corner_collapse_blocked": 0,
    "corner_collapse_packed": 0,
}

_lib: Optional[ctypes.CDLL] = None
_cocoeval: Optional[ctypes.CDLL] = None


class LevelTable(ctypes.Structure):
    """Mirror of ``LevelTable`` in csrc/levels.cuh, passed by value."""

    _fields_ = [
        ("num_levels", ctypes.c_int),
        ("h", ctypes.c_int * MAX_LEVELS),
        ("w", ctypes.c_int * MAX_LEVELS),
        ("start", ctypes.c_int * MAX_LEVELS),
    ]


def level_table(spatial_shapes: Sequence[Tuple[int, int]]) -> LevelTable:
    if len(spatial_shapes) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {len(spatial_shapes)}")
    table = LevelTable()
    table.num_levels = len(spatial_shapes)
    start = 0
    for i, (h, w) in enumerate(spatial_shapes):
        table.h[i], table.w[i], table.start[i] = h, w, start
        start += h * w
    return table


def _sources(csrc_dir: Path = CSRC_DIR):
    return sorted(csrc_dir.glob("*.cu")) + sorted(csrc_dir.glob("*.cuh"))


def source_hash(csrc_dir: Path = CSRC_DIR) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(csrc_dir):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def library_path(csrc_dir: Path = CSRC_DIR) -> Path:
    return BUILD_ROOT / source_hash(csrc_dir) / "libkernels.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the kernels")


def build(csrc_dir: Path = CSRC_DIR) -> Path:
    """Compile ``csrc_dir``'s *.cu into libkernels.so unless that source hash
    is built: one nvcc per source, all started together, then one link.
    nvcc's register and shared-memory report (``-Xptxas -v``) goes to
    build.log beside the library.  Another directory than the package's own
    builds another version of the kernels, for comparing the two."""
    out = library_path(csrc_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        jobs = []
        for src in sorted(csrc_dir.glob("*.cu")):
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(work / f"{src.stem}.o"),
                   str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        log = [(cmd, proc.communicate()[1], proc) for cmd, proc in jobs]
        for cmd, err, proc in log:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        objs = sorted(str(o) for o in work.glob("*.o"))
        link = [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(work / "libkernels.so"), *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n{proc.stderr}")
        (out.parent / "build.log").write_text("".join(err for _, err, _ in log))
        os.replace(work / "libkernels.so", out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def bind_msda(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the MSDA entry points (msda_forward,
    msda_backward, msda_backward_ordered and msda_backward_workspace,
    cuda_error_string) that ``lib`` has."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "msda_forward": [ptr, i32, LevelTable, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr],
        "msda_backward": [ptr, i32, LevelTable, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
                          ptr],
        "msda_backward_ordered": [ptr, i32, LevelTable, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                  i32, i32, i32, ptr],
    }
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i32
    if hasattr(lib, "msda_backward_workspace"):
        lib.msda_backward_workspace.argtypes = [LevelTable, i32, i32, i32, i32, i32, i32, i32]
        lib.msda_backward_workspace.restype = ctypes.c_int64
    if hasattr(lib, "cuda_error_string"):
        lib.cuda_error_string.argtypes = [i32]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = bind_msda(ctypes.CDLL(str(build())))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.grid_nms_forward.argtypes = [ptr, LevelTable, ptr, i32, i32, i32, ptr]
        lib.grid_nms_forward.restype = i32
        lib.grid_nms_forward_global.argtypes = [ptr, LevelTable, ptr, ptr, i32, i32, i32, ptr]
        lib.grid_nms_forward_global.restype = i32
        lib.assignment_forward.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.assignment_forward.restype = i32
        lib.assignment_copies_forward.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.assignment_copies_forward.restype = i32
        lib.nms_keep_cluster_forward.argtypes = [ptr, ctypes.c_float, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.nms_keep_cluster_forward.restype = i32
        lib.deform_conv_forward.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.deform_conv_forward.restype = i32
        lib.deform_conv_fused_forward.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                                  i32, ptr]
        lib.deform_conv_fused_forward.restype = i32
        lib.deform_conv_backward_workspace.argtypes = [i32, i32, i32, i32, i32]
        lib.deform_conv_backward_workspace.restype = i64
        lib.deform_conv_backward_gather.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                                    i32, i32, i32, i32, i32, ptr]
        lib.deform_conv_backward_gather.restype = i32
        lib.msda_q8_quantize.argtypes = [ptr, i32, ptr, ptr, ptr, i64, i32, ptr]
        lib.msda_q8_quantize.restype = i32
        lib.msda_q8_sample.argtypes = [ptr, ptr, LevelTable, ptr, ptr, ptr, i32,
                                       i32, i32, i32, i32, i32, i32, ptr]
        lib.msda_q8_sample.restype = i32
        lib.gather_sum.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
        lib.gather_sum.restype = i32
        lib.weighted_reduce.argtypes = [ptr, ptr, i32, ptr, i64, i32, i32, i32, i32, ptr]
        lib.weighted_reduce.restype = i32
        lib.corner_collapse_blocked.argtypes = [ptr, ptr, i32, ptr, i32, i64, i32, i32, ptr]
        lib.corner_collapse_blocked.restype = i32
        lib.corner_collapse_packed.argtypes = [ptr, ptr, i32, ptr, i32, i64, i32, ptr]
        lib.corner_collapse_packed.restype = i32
        _lib = lib
    return _lib


def cocoeval_lib() -> ctypes.CDLL:
    """The COCO evaluation inner loop (``csrc/cocoeval.cpp``, host C++), built
    with g++ on first use into
    ``build/salience_detr_torch/cocoeval-<source-hash>/libcocoeval.so``.
    Raises ``OSError`` when g++ is missing or the library does not load, and
    ``subprocess.CalledProcessError`` when g++ fails."""
    global _cocoeval
    if _cocoeval is None:
        src = CSRC_DIR / "cocoeval.cpp"
        out = BUILD_ROOT / f"cocoeval-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}" / "libcocoeval.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            work = Path(tempfile.mkdtemp(dir=out.parent))
            try:
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(work / out.name), str(src)],
                               check=True, capture_output=True, text=True)
                os.replace(work / out.name, out)
            finally:
                shutil.rmtree(work, ignore_errors=True)
        lib = ctypes.CDLL(str(out))
        f64, u8, i64 = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
        lib.evaluate_img.argtypes = [f64, i64, f64, i64, u8, u8, f64, i64, ctypes.c_double, ctypes.c_double,
                                     u8, u8]
        lib.evaluate_img.restype = None
        _cocoeval = lib
    return _cocoeval


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load().cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
