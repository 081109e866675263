"""How the port's CLIs set the card's numerics, checked on the CPU without a
launch: ``utils.env.configure_numerics`` is the one place (no cuDNN
attention behind SDPA, whose forward differed between processes on the
card; cuDNN's algorithms from heuristics; TF32 off in cuBLAS and cuDNN
only for the checks that ask for exact float32;
with ``--use-deterministic-algorithms`` also
``torch.use_deterministic_algorithms`` and cuBLAS's fixed workspace), the
train and eval CLIs both call it before
they build a model, and the MSDA backward (K3) runs the design that
``ops.deform_attn.backward_design`` names: the ordered one (no float
atomics) exactly when deterministic algorithms are on, and the dense
attention SDPA's math formulation then: bitwise repeatable forward and
backward, an image's output independent of its batch-mates, and equal to
the fused path within float32 rounding."""

import os
from types import SimpleNamespace

import pytest
import torch

from salience_detr_torch import test as eval_cli
from salience_detr_torch import train as train_cli
from salience_detr_torch.ops import deform_attn
from salience_detr_torch.utils import env
from tests.torch_port_common import TINY_TORCH


class Configured(Exception):
    """Raised by the stand-in ``configure_numerics``: the CLI went no further."""


@pytest.fixture
def restore_numerics(monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", "")  # put back as it was after the test
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG")
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.backends.cudnn.benchmark)
    cudnn_sdp = torch.backends.cuda.cudnn_sdp_enabled()
    yield
    torch.use_deterministic_algorithms(False)
    torch.backends.cuda.enable_cudnn_sdp(cudnn_sdp)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.benchmark) = before


@pytest.mark.parametrize("deterministic", [False, True])
def test_configure_numerics_sets_the_cards_numerics(restore_numerics, deterministic):
    """TF32 is left as it is (PyTorch's default in a CLI process) unless
    ``exact_float32`` turns it off, as the checks against the CPU do."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    torch.backends.cuda.enable_cudnn_sdp(True)
    env.configure_numerics(deterministic)
    assert not torch.backends.cuda.cudnn_sdp_enabled()
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    assert not torch.backends.cudnn.benchmark
    env.configure_numerics(deterministic, exact_float32=True)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    env.configure_numerics(deterministic)  # a CLI's call inside a check keeps the check's setting
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert torch.are_deterministic_algorithms_enabled() == deterministic
    if deterministic:
        assert torch.is_deterministic_algorithms_warn_only_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        assert deform_attn.backward_design() == "ordered"
    else:
        assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
        assert deform_attn.backward_design() == "scatter"


def stand_in(calls):
    def configure_numerics(deterministic=False):
        calls.append(deterministic)
        raise Configured

    return configure_numerics


@pytest.mark.parametrize("flag", [[], ["--use-deterministic-algorithms"]])
def test_train_cli_sets_the_numerics_before_its_model(tmp_path, monkeypatch, flag):
    model = tmp_path / "tiny.py"
    model.write_text("from salience_detr_torch.models.factory import SalienceDETRConfig\n"
                     f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n")
    config = tmp_path / "train.py"
    config.write_text(f"model_path = {str(model)!r}\noutput_dir = {str(tmp_path / 'out')!r}\n")
    calls = []
    monkeypatch.setattr(env, "configure_numerics", stand_in(calls))
    monkeypatch.setattr(train_cli, "build_salience_detr", lambda *a, **k: pytest.fail("model built first"))
    with pytest.raises(Configured):
        train_cli.main(["--config-file", str(config), "--device", "cpu", "--mixed-precision", "no", *flag])
    assert calls == [bool(flag)]


def test_eval_cli_sets_the_numerics_before_its_model(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(eval_cli, "configure_numerics", stand_in(calls))
    monkeypatch.setattr(eval_cli, "build_salience_detr", lambda *a, **k: pytest.fail("model built first"))
    with pytest.raises(Configured):
        eval_cli.main(["--coco-img", str(tmp_path), "--coco-ann", str(tmp_path / "ann.json"), "--device", "cpu"])
    assert calls == [False]


def test_predictor_sets_the_numerics_before_its_model(monkeypatch):
    """Serving and the eval CLI compute alike: ``Predictor`` runs the same
    setup before it builds its model."""
    from salience_detr_torch import inference

    calls = []
    monkeypatch.setattr(inference, "configure_numerics", stand_in(calls))
    monkeypatch.setattr(inference, "build_salience_detr", lambda *a, **k: pytest.fail("model built first"))
    with pytest.raises(Configured):
        inference.Predictor(inference.SalienceDETRConfig(**TINY_TORCH), device="cpu")
    assert calls == [False]


@pytest.mark.parametrize("deterministic", [False, True])
def test_k3_runs_the_design_backward_design_names(monkeypatch, deterministic):
    """The autograd backward on a non-CPU tensor (meta tensors: nothing is
    launched) calls the named design's wrapper and no other."""
    called = []

    def design(name):
        def run(value, shapes, locations, weights, d_out):
            called.append(name)
            return torch.empty_like(value), torch.empty_like(locations), torch.empty_like(weights)

        return run

    monkeypatch.setattr(deform_attn, "BACKWARD_DESIGNS", {name: design(name) for name in ("scatter", "ordered")})
    B, Q, S, C, H, G, L, P = 1, 3, 5, 32, 4, 1, 1, 2
    value = torch.empty(B, S, C, device="meta")
    locations = torch.empty(B, Q, G, L, P, 2, device="meta")
    weights = torch.empty(B, Q, H, L, P, device="meta")
    ctx = SimpleNamespace(saved_tensors=(value, locations, weights), spatial_shapes=((1, 5),),
                          needs_input_grad=(True, True, True, False))
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        grads = deform_attn._ms_deform_attn_backward(ctx, torch.empty(B, Q, C, device="meta"))
    finally:
        torch.use_deterministic_algorithms(False)
    assert called == ["ordered" if deterministic else "scatter"]
    assert len(grads) == 4 and grads[-1] is None


def test_dense_attention_runs_the_math_formulation_under_deterministic_algorithms(monkeypatch):
    from salience_detr_torch.models.bricks import attention

    torch.manual_seed(0)
    mha = attention.MultiheadAttention(32, 4)
    torch.nn.init.normal_(mha.in_proj_weight, std=0.2)
    x = torch.randn(2, 7, 32)
    mask = torch.rand(2, 7, 7) > 0.7
    mask[:, torch.arange(7), torch.arange(7)] = False  # every row keeps itself
    fused = mha(x, x, x, mask)
    backends = []
    real = attention.sdpa_kernel
    monkeypatch.setattr(attention, "sdpa_kernel", lambda b: backends.append(b) or real(b))
    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for _ in range(2):
            xr = x.clone().requires_grad_()
            out = mha(xr, xr, xr, mask)
            out.square().sum().backward()
            runs.append((out.detach(), xr.grad))
    finally:
        torch.use_deterministic_algorithms(False)
    assert backends == [attention.SDPBackend.MATH] * 2
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    torch.testing.assert_close(runs[0][0], fused.detach(), rtol=1e-5, atol=1e-6)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:  # an image's attention does not depend on its batch-mates: a rank holds fewer
        alone = mha(x[1:], x[1:], x[1:], mask[1:])
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(alone, runs[0][0][1:])


def test_repeat_check_records_two_eval_runs_alike_and_names_where_they_part(tmp_path):
    """``tools/repeat_check.py`` (how the two faults were found): two eval
    runs of the tiny model on the CPU record the same module outputs, aten
    ops and result file; a record changed at one op is reported there."""
    import json
    import subprocess
    import sys

    from salience_detr_torch.tools import repeat_check
    from tests.test_torch_port_eval import SIZES, write_split

    img_dir, ann = write_split(tmp_path, SIZES[:2])
    cfg = tmp_path / "tiny.py"
    cfg.write_text("from salience_detr_torch.models.factory import SalienceDETRConfig\n"
                   f"model_config = SalienceDETRConfig(**{TINY_TORCH!r})\n")
    records = []
    for i in range(2):
        out = tmp_path / f"rec{i}.json"
        proc = subprocess.run(
            [sys.executable, "-m", "salience_detr_torch.tools.repeat_check", "eval", "--ops", "--out", str(out), "--",
             "--coco-img", str(img_dir), "--coco-ann", str(ann), "--model-config", str(cfg), "--device", "cpu",
             "--batch-size", "2", "--save-results", str(tmp_path / f"pred{i}.json")],
            cwd=str(repeat_check.Path(repeat_check.__file__).parents[2]), capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(repeat_check.Path(repeat_check.__file__).parents[2]),
                     OMP_NUM_THREADS="2"))
        assert proc.returncode == 0, proc.stderr[-2000:]
        records.append(out)
    assert repeat_check.compare([str(r) for r in records])
    changed = json.loads(records[1].read_text())
    assert changed["calls"] and len(changed["ops"]) > len(changed["calls"])
    changed["ops"][7]["print"] = "changed"
    records[1].write_text(json.dumps(changed))
    assert not repeat_check.compare([str(r) for r in records])
    assert "ops first differ at output 7 of" in repeat_check.first_op_difference(
        json.loads(records[0].read_text())["ops"], changed["ops"])


def test_repeat_check_ranks_report_names_the_first_module_output_that_parts(tmp_path):
    """``repeat_check ranks`` reads two records of step 0 (rank 0's rows
    and the one process's): the first module output that differs at all,
    beyond 1e-6 and beyond 1e-3 of its magnitude, in call order."""
    from salience_detr_torch.tools import repeat_check

    base = [{"module": f"m{i}", "index": 0, "shape": [3], "rows": torch.full((6,), 2.0)} for i in range(5)]
    other = [dict(c, rows=c["rows"].clone()) for c in base]
    other[1]["rows"][0] += 2.0 * 2**-22  # a last-bit gap (about 2.4e-7 of 2)
    other[3]["rows"][4] += 0.01
    metrics = {"loss": 1.0, "loss_class_0": 0.5}
    torch.save({"calls": other, "metrics": dict(metrics, loss_class_0=0.5025)}, tmp_path / "ranks.pt")
    torch.save({"calls": base, "metrics": metrics}, tmp_path / "one.pt")
    report = repeat_check.ranks_report(tmp_path / "ranks.pt", tmp_path / "one.pt")
    assert report.startswith("5 module outputs compared")
    assert "beyond 0: call 1 of 5: m1[0]" in report
    assert "beyond 1e-06: call 3 of 5: m3[0] [3] gap 5.000e-03" in report
    assert "beyond 0.001: call 3 of 5" in report
    assert "largest metric gap 5.000e-03 (loss_class_0)" in report
    other[2]["shape"] = [4]
    torch.save({"calls": other, "metrics": metrics}, tmp_path / "ranks.pt")
    assert "module sequences part at call 2" in repeat_check.ranks_report(tmp_path / "ranks.pt", tmp_path / "one.pt")
