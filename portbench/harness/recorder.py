"""Records the program's discrete choices in the calls and steps that the
check compares: each top-k of the transformer and of the post-process, the
two-stage grid NMS and the Hungarian assignment, by wrapping the functions
the program's modules call (as the program's own
``tools/repeat_check.SelectionRecorder`` does).  It is entered only around
those calls and steps, never around the rest of the timed window.

The records are ``(kind, index)`` in the order the program made them; the
reference takes each site's choice from them by kind and shape
(``reference/choices.py``).  A function the program no longer calls leaves
no record, and the reference then makes its own choice there: nothing here
fails a run."""

from __future__ import annotations

from typing import List, Tuple

import torch


class ChoiceRecorder:
    def __init__(self):
        from salience_detr_torch.models.bricks import criterion, post_process, salience_transformer

        self.targets = [(salience_transformer, "stable_topk", "topk"), (salience_transformer, "grid_nms_topk", "nms"),
                        (post_process, "stable_topk", "post"), (criterion, "batched_assignment", "assign")]
        self.saved: List[Tuple[object, str, object]] = []
        self.calls: List[Tuple[str, torch.Tensor]] = []

    def _wrap(self, real, kind):
        def recording(*args, **kwargs):
            out = real(*args, **kwargs)
            index = out[1] if isinstance(out, tuple) else out
            self.calls.append((kind, index.detach()))
            return out

        return recording

    def __enter__(self):
        for module, name, kind in self.targets:
            real = getattr(module, name, None)
            if real is not None:
                self.saved.append((module, name, real))
                setattr(module, name, self._wrap(real, kind))
        return self

    def __exit__(self, *exc):
        for module, name, real in self.saved:
            setattr(module, name, real)
        self.saved.clear()

    def take(self) -> List[Tuple[str, torch.Tensor]]:
        """The choices recorded since the last ``take``, on the host."""
        out = [(kind, idx.long().cpu()) for kind, idx in self.calls]
        self.calls = []
        return out
