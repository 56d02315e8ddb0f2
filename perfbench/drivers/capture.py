"""What the timed path made, for the check: a forward hook on the
program's model that keeps, for the rows asked for, the model's input and
outputs as the forward returned them (copied on the device: a few MB, no
host transfer inside the window)."""
from __future__ import annotations

from typing import Dict, List, Optional

KEYS = ('cls_pred', 'loc_pred', 'roi_boxes', 'roi_masks', 'seg_pred')


class Capture:
    """``mark``: the traced run's marks (``harness.trace.Marks``), set at
    the forward's start and end."""

    def __init__(self, model, mark):
        self.rows: Optional[List[int]] = None   # rows of the next forward
        self.last: Dict[int, Dict] = {}         # row -> tensors [1, ...]
        self.mark = mark
        self._hooks = (
            model.register_forward_pre_hook(lambda m, a: mark('forward')),
            model.register_forward_hook(self._keep))

    def _keep(self, module, args, out):
        self.mark('forward_end')
        if not self.rows:
            return
        n = args[0].shape[0]
        self.last = {r: dict({k: out[k][r:r + 1].clone() for k in KEYS},
                             down=args[0][r:r + 1].clone())
                     for r in self.rows if r < n}

    def remove(self) -> None:
        for hook in self._hooks:
            hook.remove()
