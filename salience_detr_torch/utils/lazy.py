"""Deferred object graphs for executable-Python configs (the port's copy of
salience_detr_tpu/utils/lazy.py).

``LazyCall(fn)(**kw)`` captures a call as data instead of running it,
:func:`instantiate` replays a captured graph recursively, and
:func:`locate` / :func:`target_string` map objects to importable dotted
paths.  A captured call is a plain dict subclass (:class:`LazySpec`) with
attribute access, so a config can edit it after capture.
:func:`defer_assignments` rewrites chosen ``name = f(...)`` assignments of
a config's source into ``name = LazyCall(f)(...)`` (or a
``functools.partial``) before it runs: ``Config(path, lazy=...,
partials=...)``.
"""

from __future__ import annotations

import ast
import functools
import inspect
import pydoc
from typing import Any, Callable, Iterable, Mapping

_TARGET = "_target_"
_VARARGS = "_args_"


def locate(name: str) -> Any:
    """Import and return the object at dotted path ``name``."""
    obj = pydoc.locate(name)
    if obj is None:
        # pydoc gives up on some nested attributes (a module that re-exports
        # lazily); walk the path by hand.
        parts = name.split(".")
        for i in range(len(parts) - 1, 0, -1):
            module = pydoc.locate(".".join(parts[:i]))
            if module is not None:
                obj = module
                try:
                    for attr in parts[i:]:
                        obj = getattr(obj, attr)
                except AttributeError:
                    obj = None
                break
    if obj is None:
        raise ImportError(f"cannot locate object {name!r}")
    return obj


def target_string(t: Any) -> str:
    """Dotted path for ``t``, preferring the shortest re-importable spelling."""
    module, qualname = t.__module__, t.__qualname__
    parts = module.split(".")
    for k in range(1, len(parts)):
        candidate = ".".join(parts[:k]) + "." + qualname
        try:
            if locate(candidate) is t:
                return candidate
        except ImportError:
            pass
    return f"{module}.{qualname}"


class LazySpec(dict):
    """A captured call: plain dict with attribute sugar so configs can edit
    fields after capture (``spec.out_channels = 64``)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None


class LazyCall:
    """``LazyCall(fn)(a, b=c)`` -> :class:`LazySpec` describing the call.

    Positional arguments are folded into keyword form using the target's
    signature; a target with ``*args`` keeps them positional.
    """

    def __init__(self, target: Callable | str):
        if not (callable(target) or isinstance(target, str)):
            raise TypeError(f"LazyCall target must be callable or a dotted path, got {target!r}")
        self._target = target

    def __call__(self, *args: Any, **kwargs: Any) -> LazySpec:
        spec = LazySpec(kwargs)
        if args:
            folded, varargs = self._fold(args)
            overlap = set(folded) & set(kwargs)
            if overlap:
                raise TypeError(f"argument(s) {sorted(overlap)} given positionally and by keyword")
            spec.update(folded)
            if varargs:
                spec[_VARARGS] = list(varargs)
        spec[_TARGET] = self._target
        return spec

    def _fold(self, args: tuple) -> tuple[dict, tuple]:
        target = locate(self._target) if isinstance(self._target, str) else self._target
        try:
            params = list(inspect.signature(target).parameters.values())
        except (TypeError, ValueError):
            raise TypeError(
                f"cannot bind positional args to {target!r} (no signature); use keywords"
            ) from None
        folded: dict = {}
        for i, p in enumerate(params[: len(args)]):
            if p.kind is inspect.Parameter.VAR_POSITIONAL:
                # keep everything positional: folded names before *args would
                # otherwise collide with the leading positionals at replay
                return {}, args
            folded[p.name] = args[i]
        if len(args) > len(params):
            raise TypeError(f"{target!r} takes at most {len(params)} positional args")
        return folded, ()


def is_lazy(obj: Any) -> bool:
    return isinstance(obj, Mapping) and _TARGET in obj


def instantiate(cfg: Any) -> Any:
    """Recursively build the object graph described by ``cfg``.

    Mappings with ``_target_`` become calls (children instantiated first);
    bare lists/tuples/dicts recurse; everything else passes through.
    """
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(instantiate(x) for x in cfg)
    if is_lazy(cfg):
        kwargs = {k: instantiate(v) for k, v in cfg.items() if k not in (_TARGET, _VARARGS)}
        args = [instantiate(x) for x in cfg.get(_VARARGS, ())]
        target = cfg[_TARGET]
        if isinstance(target, str):
            target = locate(target)
        if not callable(target):
            raise TypeError(f"_target_ {cfg[_TARGET]!r} resolved to non-callable {target!r}")
        return target(*args, **kwargs)
    if isinstance(cfg, Mapping):
        return {k: instantiate(v) for k, v in cfg.items()}
    return cfg


class _DeferCalls(ast.NodeTransformer):
    """Rewrite ``name = f(...)`` into a deferred form for selected names."""

    def __init__(self, names: set[str], wrapper: str):
        self.names = names
        self.wrapper = wrapper  # "__lazy_call__" or "__partial__"

    def visit_Assign(self, node: ast.Assign) -> ast.Assign:
        self.generic_visit(node)
        if len(node.targets) == 1 and isinstance(node.value, ast.Call):
            name = ast.unparse(node.targets[0])
            if name in self.names or name.replace("'", '"') in self.names:
                fn = ast.Name(id=self.wrapper, ctx=ast.Load())
                if self.wrapper == "__lazy_call__":
                    # f(...) -> __lazy_call__(f)(...)
                    node.value = ast.Call(
                        func=ast.Call(func=fn, args=[node.value.func], keywords=[]),
                        args=node.value.args,
                        keywords=node.value.keywords,
                    )
                else:
                    # f(...) -> __partial__(f, ...)
                    node.value = ast.Call(
                        func=fn,
                        args=[node.value.func, *node.value.args],
                        keywords=node.value.keywords,
                    )
        return node


def defer_assignments(
    source: str,
    lazy: Iterable[str] = (),
    partials: Iterable[str] = (),
) -> tuple[str, dict]:
    """Rewrite config source so the named assignments are captured, not run.

    Returns ``(new_source, extra_globals)``: execute the source with the
    extra globals injected.
    """
    lazy, partials = set(lazy), set(partials)
    tree = ast.parse(source)
    if lazy:
        tree = _DeferCalls(lazy, "__lazy_call__").visit(tree)
    if partials:
        tree = _DeferCalls(partials, "__partial__").visit(tree)
    ast.fix_missing_locations(tree)
    return ast.unparse(tree), {"__lazy_call__": LazyCall, "__partial__": functools.partial}
