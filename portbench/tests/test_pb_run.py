"""Whole runs of a tiny cell on the CPU, past the look for a card: correct on
the program, and not correct with the timed path broken underneath."""

import contextlib
import sys

import pytest
import torch

from portbench.harness.common import BENCH
from portbench.tests.tiny import tiny_cell

sys.path.insert(0, str(BENCH))
import run  # noqa: E402


def one(kind, seed=2**32 + 7):
    torch.manual_seed(0)
    cell, cfg = tiny_cell(kind)
    correct, line, _ = run.run_cell(cell, seed, 1.0, False, torch.device("cpu"), 0.0, cfg)
    return correct, line


@contextlib.contextmanager
def patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_sound(kind):
    correct, line = one(kind)
    assert correct, line["checks"]
    assert list(line)[-1] == "checks"


def altered_answer():
    from salience_detr_torch.models.bricks.post_process import PostProcess

    real = PostProcess.__call__

    def call(self, *args):
        out = real(self, *args)
        out["scores"] = out["scores"].clone()
        out["scores"][:, 0] = 1.0 - out["scores"][:, 0]
        return out

    return patched(PostProcess, "__call__", call)


def half_batch_serve():
    from salience_detr_torch import inference

    real = inference.Predictor.forward

    def forward(self, images, sizes, orig):
        h = max(images.shape[0] // 2, 1)
        out = real(self, images[:h], sizes[:h], orig[:h])
        return {k: torch.cat([v, v])[:images.shape[0]] for k, v in out.items()}

    return patched(inference.Predictor, "forward", forward)


def unchanged_state():
    """The program's optimizer steps leave its parameters as they are (the
    reference's optimizer is another object, untouched)."""
    from salience_detr_torch import train

    real = train.Trainer.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self.optimizer.step = lambda *a, **k: None

    return patched(train.Trainer, "__init__", init)


def half_batch_train():
    sys.path.insert(0, str(BENCH))
    import control

    return control.plant("half_batch")


def altered_assignment():
    sys.path.insert(0, str(BENCH))
    import control

    return control.plant("altered_assignment")


@pytest.mark.parametrize("kind,fault", [("serve", altered_answer), ("serve", half_batch_serve),
                                        ("train", unchanged_state), ("train", half_batch_train),
                                        ("train", altered_assignment)])
def test_faults(kind, fault):
    with fault():
        correct, line = one(kind)
    assert not correct, line["checks"]
