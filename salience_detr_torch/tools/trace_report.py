"""Sum a device trace's time by named region (the twin of the JAX tool
``tools/trace_report.py``).

    python -m salience_detr_torch.tools.trace_report --trace traces/trace.json [--iters 3] [--depth 2]
        [--top 30] [--ops-of REGION] [--category NAME]

Reads a Chrome trace that ``torch.profiler`` exported
(``tools/profile_trace.py`` writes one and a ``meta.json`` beside it, whose
``iters`` is the default of ``--iters``) and prints device ms per iteration
by region: the path of the ranges (``record_function``) around the host
call that launched each kernel, outermost first, cut to ``--depth``
segments.  ``profile_trace`` names them after the model's modules and the
JAX package's named scopes, so the rows are the JAX report's
(``backbone``, ``transformer/encoder_layer_0``, ...).

A kernel is matched to its launch through the trace's correlation id, and
the launch to its enclosing ranges on its host thread.  A kernel of the
backward is launched from an autograd engine function, outside every range
of the forward: it goes to the region of the forward op that has the same
sequence number, and its share is printed beside each row.  Kernels whose
launch is not in the trace are the "unattributed" row; kernels launched
outside every range the "(top)" row.  The rows and the unattributed row add
up to the traced device total; the report prints that check.

In a trace without device activity (a CPU run) the units are the host's
outermost operators in place of kernels.  ``--category`` keeps the kernels
of one category of :data:`CATEGORIES` (the rows then name its owners);
``--ops-of`` also prints the top kernels of the regions under a prefix.

What differs from the JAX tool: no HLO text is needed (``--hlo`` is gone:
the ranges are in the trace itself), and the backward is attributed by
sequence number where JAX names its transposes under the forward's scopes.
Imports the standard library only."""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional

# first matching pattern names the category of a kernel
CATEGORIES = [
    ("msda_q8", r"msda_q8_sample_kernel|q8_absmax_kernel|q8_table_kernel"),
    # B6 backward: the gather's seven kernels (and the earlier design's name)
    ("deform_conv_backward", r"deform_conv_backward_kernel|dcn_(zero|count|scan_sums|scan_offsets|place|gather|"
                             r"combine)_kernel"),
    ("deform_conv_fused", r"deform_conv_fused_kernel"),
    ("deform_conv", r"deform_conv_forward_kernel"),
    ("msda", r"msda_forward_kernel"),
    ("msda_backward", r"msda_backward_kernel"),
    ("grid_nms", r"grid_nms_kernel"),
    ("hungarian", r"hungarian_kernel"),
    ("conv", r"fprop|dgrad|conv|cudnn|nchw|nhwc|implicit"),
    ("sdpa", r"flash|fmha|attention"),
    ("gemm", r"gemm|cutlass|cublas|matmul|splitK"),
    ("sort_topk", r"sort|radix|topk"),
    ("index_scatter", r"index|gather|scatter"),
    ("norm", r"norm|welford"),
    ("elementwise_reduce", r"elementwise|vectorized|reduce|unrolled|CatArray|copy|fill"),
]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD_OP = "autograd::engine::evaluate_function"


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name, re.IGNORECASE):
            return cat
    return "other"


def load_events(path: str) -> List[Dict]:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return [e for e in data["traceEvents"] if e.get("ph") == "X"]


def nest(events: List[Dict]) -> Dict[int, Optional[Dict]]:
    """Each host event's enclosing event on its thread (ranges nest)."""
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


def ancestors(e: Dict, parent: Dict[int, Optional[Dict]]) -> List[Dict]:
    out, p = [], parent.get(id(e))
    while p is not None:
        out.append(p)
        p = parent.get(id(p))
    return out


def attribute(events: List[Dict], category_name: Optional[str] = None) -> Dict:
    """Every unit of device time (a kernel, or in a CPU trace an outermost
    host operator) with its region path, its backward flag and its name;
    and the traced total."""
    host = [e for e in events if e.get("cat") not in DEVICE_CATS and not str(e.get("cat", "")).startswith("gpu_")]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    parent = nest(host)

    def regions(chain):  # outermost first
        return [a["name"] for a in reversed(chain) if a.get("cat") == "user_annotation"]

    forward: Dict[int, List[str]] = {}
    for e in host:
        seq = e.get("args", {}).get("Sequence number")
        if e.get("cat") == "cpu_op" and seq is not None and seq not in forward:
            chain = ancestors(e, parent)
            if not any(a["name"].startswith(BACKWARD_OP) for a in [e, *chain]):
                forward[seq] = regions(chain)

    def place(launch: Dict):
        """(region path, backward) of a host event, or None when its
        backward's forward op is not in the trace."""
        chain = [launch, *ancestors(launch, parent)]
        engine = next((a for a in chain if a["name"].startswith(BACKWARD_OP)), None)
        if engine is None:
            return regions(chain), False
        path = forward.get(engine.get("args", {}).get("Sequence number"))
        return (path, True) if path is not None else None

    units = []
    if device:
        launches = {e["args"]["correlation"]: e for e in host
                    if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
        for k in device:
            launch = launches.get(k.get("args", {}).get("correlation"))
            units.append((k, place(launch) if launch is not None else None))
    else:  # a CPU trace: the outermost operators
        for e in host:
            if e.get("cat") == "cpu_op" and not any(a.get("cat") == "cpu_op" for a in ancestors(e, parent)):
                units.append((e, place(e)))
    if category_name:
        units = [(k, where) for k, where in units if category(k["name"]) == category_name]
    return {"units": units, "total_us": sum(k["dur"] for k, _ in units),
            "unit": "device kernels" if device else "host operators (no device activity in the trace)"}


def report(trace: str, iters: int = 1, depth: int = 2, top: int = 30, ops_of: Optional[str] = None,
           category_name: Optional[str] = None, out=sys.stdout) -> Dict:
    """Prints the report; returns {"total_ms", "rows": {region: [ms, of
    which backward ms]}, "unattributed_ms", "check_ms", "unit"} per
    iteration."""
    found = attribute(load_events(trace), category_name)
    rows = collections.defaultdict(lambda: [0.0, 0.0])
    ops = collections.Counter()
    unattributed = collections.Counter()
    for k, where in found["units"]:
        if where is None:
            unattributed[k["name"]] += k["dur"]
            continue
        path, backward = where
        key = "/".join(path[:depth]) or "(top)"
        rows[key][0] += k["dur"]
        rows[key][1] += k["dur"] if backward else 0.0
        if ops_of is not None and key.startswith(ops_of):
            ops[k["name"]] += k["dur"]
    ms = 1e-3 / iters
    total, un = found["total_us"] * ms, sum(unattributed.values()) * ms
    summed = sum(v[0] for v in rows.values()) * ms + un
    what = f" ({category_name} only)" if category_name else ""
    print(f"total: {total:.3f} ms/iter of {found['unit']}{what} over {iters} iters", file=out)
    for key, (us, bwd) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"{us * ms:10.3f} ms/iter  (backward {bwd * ms:8.3f})  {key}", file=out)
    print(f"{un:10.3f} ms/iter  unattributed ({len(unattributed)} kernel names whose launch is not in the trace "
          f"or whose forward op is not)", file=out)
    print(f"check: rows + unattributed = {summed:.3f} of the traced total {total:.3f} ms/iter "
          f"(difference {summed - total:.3e}); {len(rows)} rows at depth {depth}", file=out)
    if ops_of is not None:
        print(f"top kernels under {ops_of}:", file=out)
        for name, us in ops.most_common(20):
            print(f"{us * ms:10.3f} ms/iter  {name[:140]}", file=out)
    return {"total_ms": total, "rows": {k: [v[0] * ms, v[1] * ms] for k, v in rows.items()},
            "unattributed_ms": un, "check_ms": summed - total, "unit": found["unit"]}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trace", required=True, help="a Chrome trace (.json or .json.gz)")
    p.add_argument("--iters", type=int, default=None, help="default: the meta.json beside the trace, else 1")
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--ops-of", default=None, help="also print the top kernels of the regions under this prefix")
    p.add_argument("--category", default=None, choices=[c for c, _ in CATEGORIES] + ["other"],
                   help="only the kernels of this category (the rows name its owners)")
    args = p.parse_args(argv)
    iters = args.iters
    meta = Path(args.trace).parent / "meta.json"
    if iters is None:
        iters = json.loads(meta.read_text())["iters"] if meta.exists() else 1
    return report(args.trace, iters, args.depth, args.top, args.ops_of, args.category)


if __name__ == "__main__":
    main()
