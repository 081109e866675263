"""salience-detr-torch: the PyTorch/CUDA port of salience_detr_tpu for NVIDIA Hopper.

The JAX package ``salience_detr_tpu`` beside this one is the reference each
ported module is held against.  This package imports ``torch`` and numpy and
never ``jax``.  Its device kernels (multi-scale deformable attention forward
and backward, the grid NMS walk, the exact assignment, and the stage kernels
of the MSDA shootout) are CUDA C++ sources under ``csrc/``, built on first use
by :mod:`salience_detr_torch.native`; on CPU tensors every kernel wrapper runs
its plain PyTorch twin instead.
"""

__version__ = "0.1.0"
