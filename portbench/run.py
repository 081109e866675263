"""The port's benchmark: one run of one cell.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's configuration in the program (``salience_detr_torch``)
with weights made on the device from the seed, warms up the cell's shapes,
drives the cell's traffic for ``--seconds`` seconds, and checks what the
timed path produced against the plain float32 reference under
``portbench/reference/``.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics) and
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s``, and a
``breakdown`` beside it), then ``checks``: each number compared, with its
limit.  The numbers compared are also the last lines of standard error.

Exits with an error and no result when CUDA is missing or has fewer cards
than the cell asks for, or when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.harness import common  # noqa: E402

common.set_cache_dirs()


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Run:
    """What a per-layer reader reads: the cell, the run's counts, the reduced
    trace of the traced window (``trace``), the traced calls or steps and
    images, the configuration's FLOP counts and the card's peaks."""

    def __init__(self, cell, result, trace, card):
        from portbench.roofline.msda import PEAKS

        self.cell, self.result, self.trace, self.card, self.peaks = cell, result, trace, card, PEAKS
        self.traced = result.get("traced", {})
        self.flops = cell["config"].get("flops", {})


def card_info(device) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        import subprocess

        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(device.index or 0)], capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except Exception:
        info["power_limit_w"] = None
    return info


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float, port_cfg=None):
    """One run; returns (correct, result line dict, check lines)."""
    import torch

    from portbench.harness import check, serve, train, weights
    from portbench.reference import model as rm

    conf = cell["config"]
    if port_cfg is None:
        from salience_detr_torch.inference import load_config

        port_cfg = load_config(ROOT / conf["port_config"])
        fields = {k: getattr(port_cfg, k) for k in conf["model"]}
        for k, v in conf["model"].items():
            got = fields[k]
            got = list(got) if isinstance(got, tuple) else got
            if isinstance(v, list) and v and isinstance(v[0], list):
                got = [list(x) for x in got]
            if got != v:
                raise SystemExit(f"{conf['port_config']}: {k} is {got!r}, the benchmark's configuration {v!r}")
        if str(port_cfg.dtype) != f"torch.{conf['dtype']}":
            raise SystemExit(f"{conf['port_config']}: dtype {port_cfg.dtype}, the benchmark's {conf['dtype']}")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    state_dict = weights.make_state_dict(rm.build(conf["model"], "meta"), seed, device)
    driver = {"serve": serve, "train": train}[cell["traffic"]["kind"]]
    trace_path = common.CACHE / "traces" / f"{cell['name']}.json"
    result = driver.run(cell, seed, seconds, trace, device, t_start, port_cfg, state_dict, sync, trace_path)
    checks = result["checks"]
    if not checks:
        checks = {"check_error": {"value": float("inf"), "limit": 0.0}}
    correct = check.passed(checks) and result["failed"] == 0
    info = card_info(device) if device.type == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 1,
                                                             "power_limit_w": None}
    power = info.pop("power_limit_w")
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"]}
    if trace:
        from portbench.harness.trace import Trace, load_events, shapes_path

        tr = Trace(load_events(trace_path), load_events(shapes_path(trace_path)))
        trace_path.unlink()
        shapes_path(trace_path).unlink()
        ctx = Run(cell, result, tr, {**info, "power_limit_w": power})
        metrics = {}
        for metric in cell["per_layer"]:
            value = common.load_reader(metric["name"])(ctx)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        line["metrics"] = metrics
        line["device"] = {**info, "memory_peak_bytes": result["memory_peak_bytes"], "busy_s": tr.busy_s,
                          "window_s": tr.window_s}
        line["breakdown"] = tr.breakdown()
        line["traced_slowdown"] = result["traced"]["slowdown"]
    else:
        line["metrics"] = {m["name"]: {"value": result["metrics"][m["name"]], "unit": m["unit"]}
                           for m in cell["end_to_end"]}
        line["device"] = {**info, "memory_peak_bytes": result["memory_peak_bytes"]}
    line["checks"] = checks
    notes = [f"power limit {power} W", f"calls or steps in the window: {result.get('calls', result.get('steps'))}",
             f"images in the window: {result['images']}, window {result['window_s']!r} s",
             f"seconds a call or step in the window, quartiles: {result['step_s']}"]
    if trace:
        notes.append(f"traced window: {result['traced']['slowdown']!r} times an untraced call or step")
    return correct, line, notes


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    cell = common.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: needs {cell['chips']} CUDA device(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    correct, line, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                                    T_START)
    found = common.forbidden_loaded()
    if found:
        print(f"portbench: the process holds {found}; no result", file=sys.stderr)
        return 3
    for n in notes:
        print(n, file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
