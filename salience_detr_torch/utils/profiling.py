"""Named regions of the forward for a device trace.

``scope(name)`` is ``torch.profiler.record_function(name)`` while a profiler
records and does nothing otherwise, so the main path is unchanged when no
profile runs.  The model marks with it the regions that the JAX package
names with ``jax.named_scope`` inside one forward function
(``salience_detr_tpu/models/detectors/salience_detr.py:85``,
``models/bricks/salience_transformer.py:438-615``); the regions that are
whole modules are named by the hooks that ``tools/profile_trace.py``
installs.  ``tools/trace_report.py`` sums a trace's device time by them."""

from __future__ import annotations

import contextlib

import torch


def scope(name: str):
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
