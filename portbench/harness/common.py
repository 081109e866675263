"""Where the benchmark's files are, and how a cell's pieces are found by name."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Dict

BENCH = Path(__file__).resolve().parent.parent  # portbench/
ROOT = BENCH.parent  # the checkout
CACHE = ROOT / "build" / "portbench"  # fixed, inside the checkout

# what the process that prints a result may not hold: the JAX package and JAX
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "salience_detr_tpu")


def set_cache_dirs() -> None:
    """Every compile cache at a fixed path inside the checkout (the program
    builds its kernels under build/salience_detr_torch/ by itself)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def benchmark() -> Dict[str, Any]:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> Dict[str, Any]:
    """The workload ``name`` with its configuration, traffic mix and limits
    read from their files."""
    bench = benchmark()
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    return {
        "name": name,
        "chips": work["chips"],
        "config": json.loads((ROOT / cfg_entry["file"]).read_text()),
        "traffic": json.loads((BENCH / "traffic" / f"{work['traffic']}.json").read_text()),
        "limits": json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])],
    }


def load_reader(metric: str):
    """The reader of a per-layer metric: ``portbench/metrics/<name>.py``'s
    ``read(run)``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def quartiles(values):
    """The first quartile, median and third quartile of ``values``
    (``statistics.quantiles``), or ``values`` itself when there are fewer
    than two."""
    import statistics

    values = [float(v) for v in values]
    return statistics.quantiles(values, n=4) if len(values) > 1 else values
