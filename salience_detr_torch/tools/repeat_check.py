"""Is a run repeatable on the card?  Record what a train step or an eval
run computes, tensor by tensor, and compare records of several runs.

    python -m salience_detr_torch.tools.repeat_check train --out F.json [--dtype bf16|f32]
        [--deterministic] [--runs 2] [--ops]
    python -m salience_detr_torch.tools.repeat_check eval --out F.json [--ops] -- <salience_detr_torch.test arguments>
    python -m salience_detr_torch.tools.repeat_check compare A.json B.json [...]
    python -m salience_detr_torch.tools.repeat_check ranks --out DIR [--world 2] [--dtype f32] [--deterministic]
        [--model-config F] [--canvas H W] [--device cuda|cpu]

* ``train``: ``--runs`` flagship ``Trainer`` steps in this process, each on
  a model built anew from seed 0 and the same synthetic batch (B=4, the
  800x1344 canvas, ``GT_COUNTS``), under ``utils.env.configure_numerics``
  (``--deterministic``: ``--use-deterministic-algorithms``); records each
  run's metrics, every parameter's gradient and value after the step (a
  SHA-1 of its bytes), the MSDA backward design, and the warnings that
  ``torch.use_deterministic_algorithms(warn_only=True)`` raised (the
  library ops without a deterministic implementation).
* ``eval``: runs ``salience_detr_torch.test.main`` in this process with a
  forward hook on every module, recording the first batch's module outputs
  in call order (module class, shape, dtype, fingerprint) and the SHA-1 of
  the saved result file.
* With ``--ops`` both also record every aten op's outputs in order
  (``OpRecorder``: the op, shape, dtype and a fingerprint) over the step,
  its backward included, or the first batch's forward; ``compare`` then
  names the first op whose outputs differ.
* ``ranks``: where a data-parallel step 0 parts from one process.  The
  ``Trainer``'s first step on the synthetic batch (the flagship, or
  ``--model-config`` on ``--canvas``), as ``--world`` gloo ranks sharing
  card 0 (``--device cpu``: the CPU) and as one process on the whole batch,
  each recording every module output of the forward whose first dimension
  is the batch (rank 0's rows of it; larger ones as an evenly strided
  sample of ``SAMPLED_ELEMENTS``) and the indices of every discrete
  selection of the transformer (each ``stable_topk`` and the grid NMS, named
  by its source line); prints, in call order, the first module output whose
  rows differ at all, the first beyond 1e-6 and beyond 1e-3 of its largest
  magnitude, the first selection that picks other indices, and the step's
  largest relative metric gap.
* ``compare``: what differs from the first record (an eval record's first
  module output that differs, or whether the result files do; a train
  run's metrics, gradients and parameters, every run of every file against
  the first run); exits 1 when anything differs.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
import warnings
from pathlib import Path
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HASHED_ELEMENTS = 1 << 16  # larger op outputs are fingerprinted by two float64 sums on the device
SAMPLED_ELEMENTS = 1 << 20  # ranks: a larger module output is kept as this many evenly strided elements
RANKS_LEVELS = (0.0, 1e-6, 1e-3)  # ranks: the first module outputs whose relative gap exceeds each


DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def digest(t: torch.Tensor) -> str:
    # a size-1 dimension leaves a "contiguous" tensor free to keep any stride:
    # copy into the standard layout before viewing the bytes
    flat = t.detach().cpu().reshape(-1).clone(memory_format=torch.contiguous_format)
    return hashlib.sha1(flat.view(torch.uint8).numpy().tobytes()).hexdigest()


def fingerprint(t: torch.Tensor) -> str:
    """The SHA-1 of a tensor's bytes, or for a large floating tensor its sum
    and its sum of magnitudes in float64 (a last-bit change moves them)."""
    if t.numel() <= HASHED_ELEMENTS or not t.is_floating_point():
        return digest(t)
    x = t.detach().double()
    return f"sums {float(x.sum())!r} {float(x.abs().sum())!r}"


class OpRecorder(TorchDispatchMode):
    """Records every aten op's tensor outputs (op, shape, dtype,
    fingerprint) in the order they run, the backward's included (autograd
    carries the mode to its thread)."""

    def __init__(self):
        super().__init__()
        self.ops: List[Dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor) and o.numel():
                self.ops.append({"op": str(func), "shape": list(o.shape), "dtype": str(o.dtype),
                                 "print": fingerprint(o)})
        return out


def train_runs(dtype: torch.dtype, deterministic: bool, runs: int, ops: bool) -> Dict:
    from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
    from salience_detr_torch.ops.deform_attn import backward_design
    from salience_detr_torch.train import Trainer
    from salience_detr_torch.utils.env import configure_numerics

    import dataclasses

    configure_numerics(deterministic)
    cfg = dataclasses.replace(load_config(DEFAULT_CONFIG), dtype=dtype)
    out: Dict = {"design": backward_design(), "runs": [], "warnings": []}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(runs):
            trainer = Trainer(cfg, "cuda", seed=0, steps_per_epoch=1)
            batch = next(trainer.batches(1, seed=0))
            recorder = OpRecorder()
            with recorder if ops else contextlib.nullcontext():
                metrics = trainer.step(batch, trainer.generator)
                torch.cuda.synchronize()
            named = list(trainer.model.named_parameters())
            out["runs"].append({
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {n: digest(p.grad) for n, p in named if p.grad is not None},
                "params": {n: digest(p) for n, p in named},
                "ops": recorder.ops,
            })
            del trainer, batch
            torch.cuda.empty_cache()
    out["warnings"] = sorted({str(w.message).split("\n")[0] for w in caught})
    return out


def eval_run(test_args: List[str], ops: bool) -> Dict:
    from salience_detr_torch import test

    calls: List[Dict] = []
    state = {"forwards": 0, "depth": 0}
    recorder = OpRecorder()

    def pre(module, args):
        if ops and state["depth"] == 0 and state["forwards"] == 0:
            recorder.__enter__()
        state["depth"] += 1

    def post(module, args, output):
        state["depth"] -= 1
        if state["forwards"] > 0:
            return
        outs = output if isinstance(output, (tuple, list)) else (output,)
        for i, o in enumerate(outs):
            if isinstance(o, torch.Tensor):
                calls.append({"module": type(module).__name__, "index": i, "shape": list(o.shape),
                              "dtype": str(o.dtype), "print": fingerprint(o)})
        if state["depth"] == 0:  # the model's own forward ended: the first batch is recorded
            state["forwards"] += 1
            if ops:
                recorder.__exit__(None, None, None)

    handles = [torch.nn.modules.module.register_module_forward_pre_hook(pre),
               torch.nn.modules.module.register_module_forward_hook(post)]
    try:
        stats = test.main(test_args)
    finally:
        for h in handles:
            h.remove()
    saved = None
    if "--save-results" in test_args:
        saved = hashlib.sha1(Path(test_args[test_args.index("--save-results") + 1]).read_bytes()).hexdigest()
    return {"calls": calls, "ops": recorder.ops, "stats": stats, "result_sha1": saved}


class SelectionRecorder:
    """While entered, records the indices (rank 0's ``rows``) of every
    ``stable_topk`` and grid NMS call of the transformer, named by the
    source line that made it; the functions are restored on exit."""

    def __init__(self, rows: int):
        from salience_detr_torch.models.bricks import salience_transformer

        self.module, self.rows, self.selections = salience_transformer, rows, []
        self.saved, self.recording = {}, True

    def wrap(self, name):
        real = getattr(self.module, name)

        def recording(*args, **kwargs):
            out = real(*args, **kwargs)
            index = out[1] if isinstance(out, tuple) else out
            if self.recording:
                line = sys._getframe(1).f_lineno
                self.selections.append({"name": f"{name} (salience_transformer.py:{line})",
                                        "indices": index.detach()[:self.rows].cpu()})
            return out

        return recording

    def __enter__(self):
        for name in ("stable_topk", "grid_nms_topk"):
            self.saved[name] = getattr(self.module, name)
            setattr(self.module, name, self.wrap(name))
        return self

    def __exit__(self, *exc):
        for name, real in self.saved.items():
            setattr(self.module, name, real)


def record_rows(world: int, dtype: torch.dtype, deterministic: bool, out: Path, config: str = None,
                canvas=None, device: str = "cuda") -> None:
    """One process of ``ranks``: a rank (under the launcher's variables) or
    the whole batch; rank 0 and the one process write ``out``."""
    import dataclasses

    from salience_detr_torch.inference import DEFAULT_CONFIG, load_config
    from salience_detr_torch.parallel.mesh import init_distributed, mean_over_ranks, shutdown
    from salience_detr_torch.tools.common import synthetic_trainer
    from salience_detr_torch.utils.env import configure_numerics

    configure_numerics(deterministic, exact_float32=True)
    mesh = init_distributed(device, "gloo")
    try:
        cfg = dataclasses.replace(load_config(config or DEFAULT_CONFIG), dtype=dtype)
        trainer, (batch,) = synthetic_trainer(cfg, mesh.device, 1, canvas=canvas,
                                              mesh=mesh if mesh.distributed else None)
        rows = batch["images"].shape[0] // (1 if mesh.distributed else world)
        names = {m: n for n, m in trainer.model.named_modules()}
        calls: List[Dict] = []
        state = {"recording": True}
        selections = SelectionRecorder(rows)

        def keep(module, args, output):
            if not state["recording"]:
                return
            outs = output if isinstance(output, (tuple, list)) else (output,)
            for i, o in enumerate(outs):
                if isinstance(o, torch.Tensor) and o.is_floating_point() and o.dim() and \
                        o.shape[0] == batch["images"].shape[0]:
                    x = o.detach()[:rows].float().reshape(-1)
                    if x.numel() > SAMPLED_ELEMENTS:
                        x = x[::-(-x.numel() // SAMPLED_ELEMENTS)]
                    calls.append({"module": names.get(module, type(module).__name__), "index": i,
                                  "shape": list(o.shape[1:]), "rows": x.cpu()})
            if module is trainer.model:  # the forward ended: the backward records nothing
                state["recording"] = selections.recording = False

        handle = torch.nn.modules.module.register_module_forward_hook(keep)
        try:
            with selections:
                metrics = trainer.step(batch, trainer.generator)
        finally:
            handle.remove()
        metrics = {k: float(v) for k, v in (mean_over_ranks(metrics) if mesh.distributed else metrics).items()}
        if mesh.rank == 0:
            torch.save({"calls": calls, "selections": selections.selections, "metrics": metrics}, out)
    finally:
        shutdown(mesh)


def ranks_report(ranks_file: Path, one_file: Path) -> str:
    """Where rank 0's module outputs first part from the one process's."""
    a, b = torch.load(ranks_file, weights_only=False), torch.load(one_file, weights_only=False)
    firsts: Dict[float, str] = {}
    compared = 0
    for i, (x, y) in enumerate(zip(a["calls"], b["calls"])):
        if (x["module"], x["index"], x["shape"]) != (y["module"], y["index"], y["shape"]):
            firsts.setdefault(-1.0, f"call {i}: {x['module']} {x['shape']} against {y['module']} {y['shape']}")
            break
        compared += 1
        gap = float((x["rows"] - y["rows"]).abs().max()) / max(float(y["rows"].abs().max()), 1e-30)
        for level in RANKS_LEVELS:
            if gap > level and level not in firsts:
                firsts[level] = f"call {i} of {len(b['calls'])}: {x['module']}[{x['index']}] {x['shape']} gap {gap:.3e}"
    flips = "none"
    for i, (x, y) in enumerate(zip(a.get("selections", []), b.get("selections", []))):
        if x["indices"].shape != y["indices"].shape or not torch.equal(x["indices"], y["indices"]):
            where = (x["indices"] != y["indices"]).nonzero() if x["indices"].shape == y["indices"].shape else None
            at = f" first at image {int(where[0][0])} rank {int(where[0][1])}" if where is not None else ""
            flips = f"selection {i} of {len(b['selections'])}: {x['name']} {list(x['indices'].shape)}{at}"
            break
    metric_gap = max(abs(a["metrics"][k] - v) / max(abs(v), 1e-12) for k, v in b["metrics"].items())
    worst = max(b["metrics"], key=lambda k: abs(a["metrics"][k] - b["metrics"][k]) / max(abs(b["metrics"][k]), 1e-12))
    parts = [f"beyond {level:g}: {firsts.get(level, 'none')}" for level in RANKS_LEVELS]
    if -1.0 in firsts:
        parts.append(f"module sequences part at {firsts[-1.0]}")
    return (f"{compared} module outputs compared; first {'; first '.join(parts)}; first selection that "
            f"differs: {flips}; largest metric gap {metric_gap:.3e} ({worst})")


def ranks_check(world: int, dtype: str, deterministic: bool, out: Path, config: str = None, canvas=None,
                device: str = "cuda") -> str:
    from salience_detr_torch.tools import ddp_check

    out.mkdir(parents=True, exist_ok=True)
    args = ["-m", "salience_detr_torch.tools.repeat_check", "ranks", "--world", str(world), "--dtype", dtype,
            "--out", str(out), "--device", device] + (["--deterministic"] if deterministic else []) + \
        (["--model-config", config] if config else []) + (["--canvas", *map(str, canvas)] if canvas else [])
    ddp_check.launch(args, world, one_device=True, timeout=900)
    record_rows(world, DTYPES[dtype], deterministic, out / "one.pt", config, canvas, device)
    return ranks_report(out / "ranks.pt", out / "one.pt")


def first_op_difference(a: List[Dict], b: List[Dict]) -> str:
    """Where two op records first part: the op, and the ops just before."""
    if not a or not b:
        return "ops not recorded" if not a and not b else "ops recorded in one record only"
    i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None:
        return f"ops equal ({len(a)} and {len(b)} outputs)"
    before = [x["op"] for x in a[max(0, i - 4):i]]
    return (f"ops first differ at output {i} of {len(a)}: {a[i]['op']} {a[i]['shape']} {a[i]['dtype']} against "
            f"{b[i]['op']} {b[i]['shape']} (after {before})")


def compare(paths: List[str]) -> bool:
    """Prints what first differs from the first record: for eval records,
    each later file against the first; for train records, every run of
    every file against the first run.  Returns whether all agree."""
    records = [json.loads(Path(p).read_text()) for p in paths]
    first, same = records[0], True
    if "runs" in first:
        runs = [(path, i, run) for path, r in zip(paths, records) for i, run in enumerate(r["runs"])]
        ref = runs[0][2]
        for path, i, run in runs[1:]:
            grads = [n for n, h in ref["grads"].items() if run["grads"].get(n) != h]
            params = [n for n, h in ref["params"].items() if run["params"].get(n) != h]
            metrics = [k for k, v in ref["metrics"].items() if run["metrics"].get(k) != v]
            same &= not (grads or params or metrics) and run["grads"].keys() == ref["grads"].keys()
            print(f"repeat_check: {path} run {i} against {paths[0]} run 0: metrics that differ {metrics}; "
                  f"gradients that differ {len(grads)} of {len(ref['grads'])} {grads[:8]}; parameters that "
                  f"differ {len(params)} of {len(ref['params'])}; {first_op_difference(ref['ops'], run['ops'])}")
        return same
    for path, other in zip(paths[1:], records[1:]):
        diff = next(((i, a) for i, (a, b) in enumerate(zip(first["calls"], other["calls"])) if a != b), None)
        files = "equal" if first["result_sha1"] == other["result_sha1"] else "differ"
        if diff is None and len(first["calls"]) == len(other["calls"]) and files == "equal" \
                and first["ops"] == other["ops"]:
            print(f"repeat_check: {path} equals {paths[0]} ({len(first['calls'])} module outputs, result file)")
            continue
        same = False
        where = "no module output" if diff is None else (
            f"module output {diff[0]} of {len(first['calls'])}, {diff[1]['module']}[{diff[1]['index']}] "
            f"{diff[1]['shape']} {diff[1]['dtype']}")
        print(f"repeat_check: {path} differs from {paths[0]} first at {where}; result files {files}; "
              f"{first_op_difference(first['ops'], other['ops'])}")
    return same


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    rest: List[str] = []
    if "--" in argv:
        argv, rest = argv[:argv.index("--")], argv[argv.index("--") + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=("train", "eval", "compare", "ranks"))
    p.add_argument("files", nargs="*", help="compare: the records")
    p.add_argument("--out")
    p.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--ops", action="store_true", help="also record every aten op's outputs")
    p.add_argument("--world", type=int, default=2, help="ranks: the ranks sharing card 0")
    p.add_argument("--model-config", default=None, help="ranks: a model config in place of the flagship")
    p.add_argument("--canvas", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="ranks: the synthetic batch's canvas in place of the train config's")
    p.add_argument("--device", default="cuda", help="ranks: cuda (card 0, the default) or cpu")
    args = p.parse_args(argv)
    if args.mode == "compare":
        return 0 if compare(args.files) else 1
    if args.mode == "ranks":
        from salience_detr_torch.parallel.mesh import launched

        where = (args.model_config, args.canvas, args.device)
        if launched():  # one rank of the check
            record_rows(args.world, DTYPES[args.dtype], args.deterministic, Path(args.out) / "ranks.pt", *where)
        else:
            print(f"repeat_check ranks: {args.world} gloo ranks against one process, {args.dtype}, "
                  f"{'--use-deterministic-algorithms' if args.deterministic else 'default numerics'}: "
                  f"{ranks_check(args.world, args.dtype, args.deterministic, Path(args.out), *where)}")
        return 0
    if args.mode == "train":
        record = train_runs(DTYPES[args.dtype], args.deterministic, args.runs, args.ops)
        print(f"repeat_check train: {args.dtype} design {record['design']}; warnings {record['warnings']}")
    else:
        record = eval_run(rest, args.ops)
    Path(args.out).write_text(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
