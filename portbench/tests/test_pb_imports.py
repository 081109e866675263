"""What runs on the card imports neither JAX nor the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (the program's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "salience_detr_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not top_level_imports(path) & JAX_SIDE, path
    for path in (BENCH / "reference").glob("*.py"):
        assert "salience_detr_torch" not in top_level_imports(path), path


def test_loaded_modules():
    """A process that imports the harness, the reference and the program's
    modules a run uses holds no JAX-side module; the reference alone holds
    none of the program's."""
    code = ("import sys; sys.path.insert(0, {root!r}); sys.path.insert(0, {bench!r}); {imports}; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    run = "import run, portbench.harness.serve, portbench.harness.train, portbench.harness.trace, " \
          "salience_detr_torch.inference, salience_detr_torch.train"
    ref = "import portbench.reference.model, portbench.reference.optim, portbench.reference.preprocess, " \
          "portbench.reference.lowp"
    for imports, banned in ((run, JAX_SIDE), (ref, JAX_SIDE | {"salience_detr_torch"})):
        out = subprocess.run([sys.executable, "-c", code.format(root=str(BENCH.parent), bench=str(BENCH),
                                                                 imports=imports)],
                             capture_output=True, text=True, check=True)
        loaded = set(eval(out.stdout.strip().splitlines()[-1]))
        assert not loaded & banned, loaded & banned
