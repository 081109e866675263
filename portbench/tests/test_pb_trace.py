"""The trace reduction on a canned trace: regions, backward attribution,
the union of device intervals, idle gaps, GEMM names, the MSDA operator's
forward and backward kernels."""

import json

from portbench.harness import trace as tr
from portbench.roofline.msda import forward_work, share


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def canned():
    return [
        ev(tr.WINDOW, "user_annotation", 0, 1000),
        ev("model", "user_annotation", 10, 500),
        ev("backbone", "user_annotation", 20, 100),
        ev("aten::conv2d", "cpu_op", 25, 50, **{"Sequence number": 1}),
        ev("cudaLaunchKernel", "cuda_runtime", 30, 5, correlation=11),
        ev("transformer", "user_annotation", 200, 200),
        ev(tr.MSDA_OP, "cpu_op", 210, 50, **{"Sequence number": 2, "Input Dims": [[1, 10, 8], [1, 4, 1, 1, 2, 2], [1, 4, 2, 1, 2], []],
                                             "Input type": ["c10::BFloat16", "float", "float", "ScalarList"]}),
        ev("cudaLaunchKernel", "cuda_runtime", 220, 5, correlation=12),
        ev("aten::mm", "cpu_op", 300, 20, **{"Sequence number": 3}),
        ev("cudaLaunchKernel", "cuda_runtime", 305, 5, correlation=13),
        # backward, on the autograd thread
        ev(tr.BACKWARD_OP + ": MsdaBackward", "cpu_op", 600, 100, tid=2, **{"Sequence number": 2}),
        ev("cudaLaunchKernel", "cuda_runtime", 610, 5, tid=2, correlation=14),
        # device
        ev("implicit_convolve_sgemm", "kernel", 100, 100, tid=7, correlation=11),
        ev("msda_forward_kernel<bf16>", "kernel", 150, 100, tid=8, correlation=12),  # overlaps the conv
        ev("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_TNN", "kernel", 400, 50, tid=7, correlation=13),
        ev("msda_backward_kernel", "kernel", 700, 200, tid=7, correlation=14),
    ]


def test_reduction(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": canned()}))
    t = tr.Trace(tr.load_events(path))
    assert t.window_s == 1e-3
    # 100-250 (union of two overlapping kernels), 400-450, 700-900
    assert abs(t.busy_s - (150 + 50 + 200) * 1e-6) < 1e-12
    assert t.kernels() == 4
    assert abs(t.region_s("backbone") - 100e-6) < 1e-12
    assert abs(t.region_s("transformer") - (100 + 50 + 200) * 1e-6) < 1e-12  # backward by sequence number
    assert abs(t.region_s("transformer", backward=True) - 200e-6) < 1e-12
    assert tr.category("nvjet_hsh_128x256_64x4_1x2_h_bz_coopA_TNN") == "gemm"
    fwd, bwd = t.msda("fwd"), t.msda("bwd")
    assert [round(s * 1e6, 9) for _, s in fwd] == [100] and [round(s * 1e6, 9) for _, s in bwd] == [200]
    moved, ops = forward_work([1, 10, 8], [1, 4, 1, 1, 2, 2], [1, 4, 2, 1, 2], 2)
    assert moved == 10 * 8 * 2 + 4 * (4 * 2 * 2 + 4 * 2 * 2) + 4 * 8 * 2
    assert abs(share(fwd, forward_work) - 100 * (moved / 3.35e12) / 100e-6) < 1e-9
    b = t.breakdown()
    assert b["device_ops"][0][0] == "msda_backward_kernel"
    gaps = dict(b["idle_gaps"])
    assert abs(sum(gaps.values()) - (1000 - 400) * 1e-6) < 1e-12
    assert abs(gaps["transformer | aten::mm"] - 150e-6) < 1e-12  # 250-400, before the GEMM's launch


def test_union_and_gaps():
    assert tr.union_us([(0, 10), (5, 20), (30, 40)], 0, 50) == 30
    assert tr.gaps([(0, 10), (5, 20), (30, 40)], 0, 50) == [(20, 30), (40, 50)]
    assert tr.union_us([(-5, 5)], 0, 10) == 5


def test_shapes_from_the_second_pass(tmp_path):
    """The timed pass records no shapes; the n-th MSDA call takes them from
    the n-th call of the shapes pass, and none where the counts differ."""
    def bare():
        return [dict(e, args={k: v for k, v in e["args"].items() if k not in ("Input Dims", "Input type")})
                for e in canned()]

    shaped = [e for e in canned() if e["name"] == tr.MSDA_OP]
    t = tr.Trace(bare(), shaped)
    (op, seconds), = t.msda("fwd")
    assert op["args"]["Input Dims"][0] == [1, 10, 8]
    assert share(t.msda("fwd"), forward_work) is not None
    none = tr.Trace(bare(), shaped * 2)
    assert share(none.msda("fwd"), forward_work) is None


def test_regions_only_for_the_read_modules():
    import torch

    model = torch.nn.Sequential()
    model.add_module("backbone", torch.nn.Sequential(torch.nn.Linear(2, 2)))
    model.add_module("transformer", torch.nn.Sequential())
    model.transformer.add_module("neck", torch.nn.Identity())
    regions = tr.ModuleRegions(model)
    assert sorted(regions.names.values()) == ["backbone", "model", "repnet_neck", "transformer"]
    with regions:
        model(torch.zeros(1, 2))
    assert not regions.ranges
