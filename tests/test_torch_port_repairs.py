"""Two repairs, on the CPU.  ROADMAP C-27: under the deterministic numerics
(``torch.use_deterministic_algorithms``) the salience predictor's last
Linear computes one GEMM an image, so an image's scores do not depend on
its batch-mates: a batch of 4 is bitwise equal on its first 2 images to a
call on those 2, and the default numerics keep one GEMM a batch.  And
``python -m salience_detr_torch.tools.ddp_check`` runs on the card unless
``--device cpu`` is given: without a card it refuses by name."""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from salience_detr_torch.models.bricks.salience_transformer import MaskPredictor
from salience_detr_torch.models.layers import PerImageLinear
from salience_detr_torch.tools import ddp_check


class GemmCount(TorchDispatchMode):
    """Counts the matrix products that run."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.addmm, torch.ops.aten.mm, torch.ops.aten.bmm,
                                   torch.ops.aten.matmul, torch.ops.aten.linear):
            self.calls += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(False)


def last_linear(C=64):
    """The salience predictor's last Linear, (B, hw, C / 4) -> (B, hw, 1)."""
    torch.manual_seed(0)
    return MaskPredictor(C, C).layer2[-1]


def test_last_linear_of_the_salience_predictor_is_per_image():
    predictor = MaskPredictor(64, 64)
    assert type(predictor.layer2[-1]) is PerImageLinear
    assert sum(isinstance(m, PerImageLinear) for m in predictor.modules()) == 1


def test_salience_scores_do_not_depend_on_batch_mates_under_the_flag(deterministic):
    last = last_linear()
    with torch.no_grad():
        hidden = torch.randn(4, 300, 16)  # the last Linear's input, (B, hw, C / 4)
        with GemmCount() as count:
            four = last(hidden)
        assert count.calls == 4
        assert torch.equal(four[:2], last(hidden[:2]))
        assert all(torch.equal(four[i:i + 1], last(hidden[i:i + 1])) for i in range(4))


def test_default_numerics_keep_one_gemm_a_batch():
    last = last_linear()
    hidden = torch.randn(4, 300, 16)
    with torch.no_grad(), GemmCount() as count:
        out = last(hidden)
    assert count.calls == 1
    torch.testing.assert_close(out, torch.nn.functional.linear(hidden, last.weight, last.bias), rtol=0, atol=0)


def test_ddp_check_defaults_to_the_card_and_refuses_without_one(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device cuda requested"):
        ddp_check.main(["bn", "--inputs", str(tmp_path / "x.npz"), "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        ddp_check.main(["loader", "--spec", str(tmp_path / "s.json"), "--out", str(tmp_path)])
