"""The port's deferred config (salience_detr_torch/utils/lazy.py and the
``lazy=``/``partials=`` branch of its ``Config``): the cases of
tests/test_lazy_config.py against the port's copy, and the copy's
captured specs replayed by the JAX package's ``instantiate`` and back."""

import functools

import pytest

from salience_detr_tpu.utils import lazy as jax_lazy
from salience_detr_torch.utils.config import Config
from salience_detr_torch.utils.lazy import LazyCall, LazySpec, instantiate, is_lazy, locate, target_string
from tests.test_lazy_config import Widget, variadic
from tests.torch_port_common import two_torch_threads  # noqa: F401


def test_capture_and_instantiate():
    spec = LazyCall(Widget)(size=3, color="blue")
    assert isinstance(spec, LazySpec) and spec["_target_"] is Widget and is_lazy(spec)
    w = instantiate(spec)
    assert (w.size, w.color) == (3, "blue")


def test_edit_after_capture():
    spec = LazyCall(Widget)(size=3)
    spec.size = 7
    assert instantiate(spec).size == 7
    del spec.size
    with pytest.raises(AttributeError):
        spec.size


def test_positional_folding_and_varargs():
    assert instantiate(LazyCall(Widget)(5, "green")).color == "green"
    assert instantiate(LazyCall(variadic)(1, 2, 3, scale=10)) == 60
    with pytest.raises(TypeError):
        LazyCall(Widget)(5, size=5)  # duplicate positional/keyword
    with pytest.raises(TypeError):
        LazyCall(42)


def test_recursive_graph_and_lists():
    spec = LazyCall(Widget)(size=1, parts=[LazyCall(Widget)(size=2), LazyCall(Widget)(size=3)])
    w = instantiate(spec)
    assert [p.size for p in w.parts] == [2, 3]
    assert instantiate({"a": LazyCall(Widget)(size=4)})["a"].size == 4


def test_string_target_and_locate_roundtrip():
    path = target_string(Widget)
    assert locate(path) is Widget
    spec = LazySpec({"_target_": "collections.OrderedDict", "a": 1})
    assert dict(instantiate(spec)) == {"a": 1}
    with pytest.raises(ImportError):
        locate("no_such_module_anywhere.thing")


def test_config_lazy_and_partial_assignments(tmp_path):
    cfg_file = tmp_path / "cfg.py"
    cfg_file.write_text(
        "from tests.test_lazy_config import Widget, variadic\n"
        "model = Widget(4, color='teal')\n"
        "optimizer = variadic(10, scale=2)\n"
        "eager = variadic(1, 1)\n"
    )
    cfg = Config(str(cfg_file), lazy=("model",), partials=("optimizer",))
    assert isinstance(cfg.model, LazySpec)
    assert instantiate(cfg.model).color == "teal"
    assert isinstance(cfg.optimizer, functools.partial)
    assert cfg.optimizer() == 20
    assert cfg.eager == 2  # untouched assignments still execute eagerly
    plain = Config(str(cfg_file))
    assert isinstance(plain.model, Widget) and plain.optimizer == 20


@pytest.mark.parametrize("build", ["port", "jax"])
def test_specs_replay_in_either_package(build):
    """A graph captured by one package's LazyCall instantiates through the
    other's, to the same objects."""
    make = LazyCall if build == "port" else jax_lazy.LazyCall
    spec = make(Widget)(2, parts=[make(variadic)(1, 2, scale=3)])
    for replay in (instantiate, jax_lazy.instantiate):
        w = replay(spec)
        assert (w.size, w.color, w.parts) == (2, "red", (9,))
    source = "model = Widget(4, color='teal')\nopt = variadic(1, 2)\n"
    from salience_detr_torch.utils.lazy import defer_assignments

    assert defer_assignments(source, ("model",), ("opt",))[0] == jax_lazy.defer_assignments(
        source, ("model",), ("opt",))[0]
