"""Executable-Python config files (the port's copy of
salience_detr_tpu/utils/config.py's ``Config``).

A config file assigns plain values and/or a ``model_config =
SalienceDETRConfig(...)``; ``Config(path)`` runs it and exposes its public
globals as attributes.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types
from typing import Any, Dict


class Config:
    """Executes a Python config file and exposes its globals as attributes;
    keyword ``overrides`` replace values of the file.

    ``lazy=("model",)`` / ``partials=("optimizer",)`` defer the named
    assignments instead of running them: a lazy name becomes a
    ``LazySpec``, replayed later with :func:`salience_detr_torch.utils.lazy.instantiate`,
    a partial name a ``functools.partial``.
    """

    def __init__(self, path: str, lazy=(), partials=(), **overrides: Any):
        path = os.path.abspath(path)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        # allow configs to import siblings
        sys.path.insert(0, os.path.dirname(path))
        try:
            if lazy or partials:
                from salience_detr_torch.utils.lazy import defer_assignments

                with open(path) as f:
                    source = f.read()
                source, namespace = defer_assignments(source, lazy, partials)
                exec(compile(source, path, "exec"), namespace)
            else:
                name = f"_cfg_{abs(hash(path))}"
                spec = importlib.util.spec_from_file_location(name, path)
                module = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(module)
                namespace = vars(module)
        finally:
            sys.path.pop(0)
        self._values: Dict[str, Any] = {
            k: v
            for k, v in namespace.items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)
        }
        self._values.update(overrides)
        self.path = path

    def __getattr__(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(name) from None

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(name, default)

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)

    def pretty(self) -> str:
        lines = []
        for k, v in sorted(self._values.items()):
            r = repr(v)
            if len(r) > 120:
                r = r[:117] + "..."
            lines.append(f"{k} = {r}")
        return "\n".join(lines)
