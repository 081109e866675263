#!/usr/bin/env python3
"""The DCNv2 backward's designs side by side on one CUDA card.

    python tools/dcn_backward_ab.py [DIR ...]

Builds the shipped kernels (salience_detr_torch/csrc/) and each DIR (another
version of csrc/, or tools/dcn_halo/), and prints the registers, stack and
spills of each DCN backward kernel from the build logs.  Then at each DCN
layer shape of R50-DCN (B=4, bf16) and random offsets of std 0, 2 and 8 px:
holds each library's backward, a whole call as its wrapper makes it
(``chip_smoke.dcn_backward_call``), against the plain backward, checks that
two calls of the shipped one give the same bits, and times every library in
turns (in the order given, then reversed).  At three shapes (std 2) it also
prints each library's device time by kernel (torch.profiler).  Fails
without a CUDA device.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from salience_detr_torch import native  # noqa: E402
from salience_detr_torch.ops import deform_conv as dcn_ops  # noqa: E402

SHAPES = [(128, 200, 336, 2), (128, 100, 168, 1), (256, 100, 168, 2), (256, 50, 84, 1), (512, 50, 84, 2),
          (512, 25, 42, 1)]
PROFILED = {(128, 100, 1), (256, 50, 1), (512, 25, 1)}


def build_report(log_path):
    """name: [registers, stack frame, spill stores] of each DCN backward kernel in a build log."""
    log = Path(log_path).read_text().splitlines()
    out = []
    for i, line in enumerate(log):
        found = re.search(r"dcn_\w+?_kernel\w{0,24}", line)
        if "Compiling entry" in line and found:
            info = " ".join(log[i + 1:i + 4])
            out.append(f"{found.group(0)}: "
                       f"{re.findall(r'Used \d+ registers|\d+ bytes stack frame|\d+ bytes spill stores', info)}")
    return out


def by_kernel(run, lib, iters=5):
    """Device us per call of run(lib) by kernel name."""
    run(lib)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run(lib)
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            found = re.search(r"dcn_\w+|deform_conv_\w+", e.name)
            key = found.group(0) if found else e.name[:40]
            rows[key] = rows.get(key, 0.0) + e.time_range.elapsed_us() / iters
    return {k: round(v, 1) for k, v in sorted(rows.items(), key=lambda kv: -kv[1])}


def main(argv=None):
    dirs = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise RuntimeError("dcn_backward_ab: needs a CUDA device")
    print(cs.card_line())
    shipped = native.build()
    libs = {d: cs.baseline_library(d) for d in dirs}
    libs["shipped"] = native.load()
    for path in [shipped] + [native.library_path(Path(d).resolve()) for d in dirs]:
        print(path.parent.name, *build_report(path.parent / "build.log"), sep="\n  ")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for C, H, W, stride in SHAPES:
        B, Ho, Wo = 4, dcn_ops.output_size(H, stride), dcn_ops.output_size(W, stride)
        for std in (0.0, 2.0, 8.0):
            x = torch.randn(B, H, W, C, generator=gen, device="cuda").bfloat16()
            offsets = torch.randn(B, Ho, Wo, 18, generator=gen, device="cuda") * std
            mask = torch.rand(B, Ho, Wo, 9, generator=gen, device="cuda")
            d_cols = torch.randn(B, Ho, Wo, 9, C, generator=gen, device="cuda").bfloat16()
            run = cs.dcn_backward_call(x, offsets, mask, stride, d_cols)
            errs = {n: cs.check_dcn_grads(run(lib), x, offsets, mask, stride, d_cols, n) for n, lib in libs.items()}
            first = [t.clone() for t in run(libs["shipped"])]
            repeatable = all(torch.equal(a, b) for a, b in zip(first, run(libs["shipped"])))
            order = list(libs.items())
            times = {n: round(cs.cuda_ms(lambda: run(lib), 10), 4) for n, lib in order}
            again = {n: round(cs.cuda_ms(lambda: run(lib), 10), 4) for n, lib in reversed(order)}
            print(f"C={C} {H}x{W} stride={stride} std={std}: max_abs_err {errs} repeatable {repeatable} "
                  f"ms {times} again {again}", flush=True)
            if std == 2.0 and (C, H, stride) in PROFILED:
                for n, lib in order:
                    print(f"  {n} {by_kernel(run, lib)}")


if __name__ == "__main__":
    main()
