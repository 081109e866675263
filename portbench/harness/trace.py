"""The traced window: named regions (hooks on the few modules the readers
read, and the criteria and post-processing, as the program's
``tools/profile_trace.py`` names them), ``torch.profiler`` over host and
device without recorded shapes, and the reduction of its Chrome trace to
what the per-layer readers read.  The shapes of the deformable attention's
calls come from a second, untimed pass over the same work under a host-only
profile that records shapes; the n-th call of the operator there gives the
n-th call's shapes in the timed pass.

The reduction is the arithmetic of the program's ``tools/trace_report.py``,
frozen here: a kernel is matched to its launch by correlation id, the launch
to the ranges around it on its host thread; a backward kernel, launched from
an autograd engine function, goes to the region of the forward operator with
the same sequence number.  Busy time is the union of every kernel, copy and
set interval on every stream inside the window, so overlapping kernels count
once."""

from __future__ import annotations

import collections
import contextlib
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# the modules that get a region, by path, and the region's name; the
# readers name regions by their path of names ("transformer/repnet_neck")
REGIONS = {"": "model", "backbone": "backbone", "neck": "channel_mapper", "transformer": "transformer",
           "transformer.neck": "repnet_neck", "denoising_generator": "denoising_generator"}
WINDOW = "portbench_window"
CALL = "portbench_call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD_OP = "autograd::engine::evaluate_function"
MSDA_OP = "salience_detr::ms_deform_attn"

# first matching pattern names a kernel's category (cuBLAS's Hopper GEMMs
# are nvjet_*)
CATEGORIES = [
    ("msda", r"msda_forward_kernel"),
    ("msda_backward", r"msda_backward"),
    ("grid_nms", r"grid_nms_kernel"),
    ("hungarian", r"hungarian_kernel|assignment"),
    ("gemm", r"nvjet|gemm|cutlass|cublas|matmul|splitK|sm90_xmma"),
    ("conv", r"fprop|dgrad|wgrad|conv|cudnn|nchw|nhwc|implicit"),
    ("sdpa", r"flash|fmha|attention"),
    ("sort_topk", r"sort|radix|topk"),
    ("index_scatter", r"index|gather|scatter"),
    ("norm", r"norm|welford"),
    ("elementwise_reduce", r"elementwise|vectorized|reduce|unrolled|CatArray|copy|fill"),
]


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name, re.IGNORECASE):
            return cat
    return "other"


class ModuleRegions:
    """While entered, each call of the modules of ``REGIONS`` found in
    ``model`` runs inside a ``record_function`` of its region's name."""

    def __init__(self, model: torch.nn.Module):
        modules = dict(model.named_modules())
        self.names = {modules[path]: name for path, name in REGIONS.items() if path in modules}
        self.ranges: List[record_function] = []
        self.handles = []

    def pre(self, module, args):
        rf = record_function(self.names[module])
        rf.__enter__()
        self.ranges.append(rf)

    def post(self, module, args, output):
        self.ranges.pop().__exit__(None, None, None)

    def __enter__(self):
        for m in self.names:
            self.handles.append(m.register_forward_pre_hook(self.pre))
            self.handles.append(m.register_forward_hook(self.post, always_call=True))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles.clear()


class NamedCalls:
    """While entered, each call of the given plain classes runs inside a
    ``record_function`` of its name."""

    def __init__(self, names: Dict[type, str]):
        self.names, self.saved = names, {}

    def __enter__(self):
        for cls, name in self.names.items():
            real = self.saved[cls] = cls.__call__

            def named(obj, *args, _real=real, _name=name, **kwargs):
                with record_function(_name):
                    return _real(obj, *args, **kwargs)

            cls.__call__ = named
        return self

    def __exit__(self, *exc):
        for cls, real in self.saved.items():
            cls.__call__ = real


def program_regions(model) -> contextlib.ExitStack:
    from salience_detr_torch.models.bricks.criterion import SalienceCriterion, SetCriterion
    from salience_detr_torch.models.bricks.post_process import PostProcess

    stack = contextlib.ExitStack()
    stack.enter_context(ModuleRegions(model))
    stack.enter_context(NamedCalls({SetCriterion: "criterion", SalienceCriterion: "salience_criterion",
                                    PostProcess: "post_process"}))
    return stack


def traced(model, path: Path, work) -> Dict[str, float]:
    """Runs ``work()`` profiled inside the window range and writes the
    Chrome trace to ``path``; then runs it again under a host-only profile
    with recorded shapes and writes that to ``shapes_path(path)``.  Returns
    the traced window's length in seconds."""
    import time

    with program_regions(model), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            work()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        work()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(shapes_path(path)))
    return {"seconds": seconds}


def shapes_path(path: Path) -> Path:
    return path.with_name(path.stem + ".shapes.json")


# ------------------------------------------------------------------ reduction

def load_events(path) -> List[Dict]:
    with open(path) as f:
        data = json.load(f)
    return [e for e in data["traceEvents"] if e.get("ph") == "X"]


def _nest(events: List[Dict]) -> Dict[int, Optional[Dict]]:
    parent: Dict[int, Optional[Dict]] = {}
    threads = collections.defaultdict(list)
    for e in events:
        threads[(e.get("pid"), e.get("tid"))].append(e)
    for evs in threads.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict] = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            parent[id(e)] = stack[-1] if stack else None
            stack.append(e)
    return parent


def _chain(e: Dict, parent) -> List[Dict]:
    out, p = [], parent.get(id(e))
    while p is not None:
        out.append(p)
        p = parent.get(id(p))
    return out


def union_us(intervals, lo: float, hi: float) -> float:
    total, end = 0.0, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle stretches (start, end) of the window between merged intervals."""
    out, end = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if hi > end:
        out.append((end, hi))
    return out


class Trace:
    """A reduced trace.  ``units``: (kernel event, region path or None,
    backward flag, MSDA role "fwd" / "bwd" / None, the MSDA op event)."""

    def __init__(self, events: List[Dict], shape_events: Optional[List[Dict]] = None):
        host = [e for e in events if e.get("cat") not in DEVICE_CATS and not str(e.get("cat", "")).startswith("gpu_")]
        device = [e for e in events if e.get("cat") in DEVICE_CATS]
        window = next((e for e in host if e.get("name") == WINDOW), None)
        if window is None:
            raise ValueError("the trace has no window range")
        self.lo, self.hi = window["ts"], window["ts"] + window["dur"]
        parent = _nest(host)
        self.parent = parent

        def regions(chain):
            return [a["name"] for a in reversed(chain) if a.get("cat") == "user_annotation"
                    and a["name"] not in (WINDOW, CALL)]

        forward, fwd_ops = {}, {}
        for e in host:
            seq = e.get("args", {}).get("Sequence number")
            if e.get("cat") == "cpu_op" and seq is not None and seq not in forward:
                chain = _chain(e, parent)
                if not any(a["name"].startswith(BACKWARD_OP) for a in [e, *chain]):
                    forward[seq] = regions(chain)
                    fwd_ops[seq] = e
        launches = {e["args"]["correlation"]: e for e in host
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        self.units = []
        for k in device:
            if k["ts"] + k["dur"] <= self.lo or k["ts"] >= self.hi:
                continue
            launch = launches.get(k.get("args", {}).get("correlation"))
            path, backward, role, op = None, False, None, None
            if launch is not None:
                chain = [launch, *_chain(launch, parent)]
                engine = next((a for a in chain if a["name"].startswith(BACKWARD_OP)), None)
                if engine is None:
                    path = regions(chain)
                    op = next((a for a in chain if a["name"] == MSDA_OP), None)
                    role = "fwd" if op is not None else None
                else:
                    seq = engine.get("args", {}).get("Sequence number")
                    path, backward = forward.get(seq), True
                    fop = fwd_ops.get(seq)
                    if fop is not None and fop["name"] == MSDA_OP:
                        role, op = "bwd", fop
            self.units.append((k, path, backward, role, op, launch))
        self.intervals = [(k["ts"], k["ts"] + k["dur"]) for k, *_ in self.units]
        self.host = host
        if shape_events is not None:
            self.attach_shapes(shape_events)

    def attach_shapes(self, shape_events: List[Dict]) -> None:
        """Gives the n-th call of the MSDA operator the recorded inputs of the
        n-th call in ``shape_events`` (the same work profiled again), where
        both passes made as many calls."""
        ops = sorted((e for e in self.host if e.get("name") == MSDA_OP), key=lambda e: e["ts"])
        shaped = sorted((e for e in shape_events if e.get("name") == MSDA_OP), key=lambda e: e["ts"])
        if len(ops) != len(shaped):
            return
        for op, sh in zip(ops, shaped):
            args = op.setdefault("args", {})
            for key in ("Input Dims", "Input type"):
                if key in sh.get("args", {}):
                    args[key] = sh["args"][key]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_us(self.intervals, self.lo, self.hi) * 1e-6

    def kernels(self) -> int:
        return sum(1 for k, *_ in self.units if k.get("cat") == "kernel")

    def region_s(self, *prefixes: str, backward: Optional[bool] = None) -> float:
        """Device seconds of kernels whose region path (without the root
        ``model``) starts with one of ``prefixes`` ("a/b")."""
        total = 0.0
        for k, path, bwd, *_ in self.units:
            if path is None or (backward is not None and bwd != backward):
                continue
            key = "/".join(p for p in path if p != "model")
            if any(key == p or key.startswith(p + "/") for p in prefixes):
                total += k["dur"]
        return total * 1e-6

    def msda(self, role: str):
        """[(op event, device seconds of its kernels)] of the MSDA op's
        forward ("fwd") or backward ("bwd") calls."""
        per = collections.defaultdict(float)
        ops = {}
        for k, _, _, r, op, _ in self.units:
            if r == role:
                per[id(op)] += k["dur"] * 1e-6
                ops[id(op)] = op
        return [(ops[i], s) for i, s in per.items()]

    def spans(self, name: str) -> List[Dict]:
        return [e for e in self.host if e.get("name") == name and self.lo <= e["ts"] <= self.hi]

    def breakdown(self, top: int = 10) -> Dict:
        ops = collections.Counter()
        for k, *_ in self.units:
            ops[k["name"]] += k["dur"] * 1e-6
        idle = collections.Counter()
        starts = sorted(((k["ts"], path, launch) for k, path, _, _, _, launch in self.units), key=lambda x: x[0])
        import bisect

        keys = [s for s, _, _ in starts]
        for g0, g1 in gaps(self.intervals, self.lo, self.hi):
            i = bisect.bisect_left(keys, g1)
            label = "(end of window)"
            if i < len(starts):
                _, path, launch = starts[i]
                op = None
                if launch is not None:
                    op = next((a["name"] for a in _chain(launch, self.parent) if a.get("cat") == "cpu_op"), None)
                where = "/".join(p for p in (path or []) if p != "model") or "(top)"
                label = f"{where} | {op or 'no operator'}"
            idle[label] += (g1 - g0) * 1e-6
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}

