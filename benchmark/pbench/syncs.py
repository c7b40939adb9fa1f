"""Host syncs counted under torch.cuda.set_sync_debug_mode("warn"): the
method of chip_smoke.py's fused_step_syncs, frozen here. Every operation
that makes the host wait for the card (a copy to the host, .item(), a
boolean mask's size) warns once; the warnings are counted, and a control
sync (.item()) first shows that the mode reports syncs at all."""

from __future__ import annotations

import contextlib
import warnings

import torch


class SyncCounter:
    """Counts the host syncs made while `counting` is True, between
    start() and stop()."""

    def __init__(self):
        self.count = 0
        self.counting = False
        self.control = 0
        self._cm = None

    def start(self):
        self._cm = contextlib.ExitStack()
        self._cm.enter_context(warnings.catch_warnings())
        warnings.simplefilter("always")
        warnings.showwarning = self._record
        torch.cuda.set_sync_debug_mode("warn")
        self.counting = True
        torch.zeros(1, device="cuda").item()            # control sync
        self.control, self.count = self.count, 0
        self.counting = False

    def stop(self):
        torch.cuda.set_sync_debug_mode(0)
        self._cm.close()

    def _record(self, message, category, filename, lineno, file=None,
                line=None):
        if self.counting:
            self.count += 1
