"""salience-detr-torch: the PyTorch/CUDA port of salience_detr_tpu for NVIDIA Hopper.

The JAX package ``salience_detr_tpu`` beside this one is the reference each
ported module is held against.  This package imports ``torch`` and numpy and
never ``jax``.  Its device kernels (multi-scale deformable attention forward
and backward, the grid NMS walk, the exact assignment, the post-process's
greedy NMS keep mask, the DCNv2 sampling and layer, the int8 MSDA, and the
stage kernels of the MSDA shootout) are CUDA C++ sources under ``csrc/``,
built on first use by :mod:`salience_detr_torch.native`; on CPU tensors
every kernel wrapper runs its plain PyTorch twin instead.
"""

__version__ = "0.1.0"

# registers the kernels' operators (torch.ops.salience_detr.*), which a
# program saved by tools/export.py calls: importing the package is enough to
# load one
from salience_detr_torch.ops import deform_attn as _deform_attn  # noqa: E402,F401
from salience_detr_torch.ops import deform_conv as _deform_conv  # noqa: E402,F401
from salience_detr_torch.ops import nms as _nms  # noqa: E402,F401
