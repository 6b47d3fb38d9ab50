"""Straggler detection: counterpart of ``repro.train.elastic``'s
``StepWatchdog``.

On a straggling or dead step the launcher falls back to the
checkpoint-restart path (``train.checkpoint``); the loader needs no
coordination, its batches being a pure function of (seed, step). The
reference's resize path (``remesh``, ``check_batch``, ``reshard``) comes
with the mesh slice.
"""
from __future__ import annotations

import time


class StepWatchdog:
    """Per-step timeout hook. The launcher calls ``tick()`` after every
    completed step; once ``grace_steps`` steps are past, a step that took
    longer than ``timeout_s`` (host clock) sets ``tripped``."""

    def __init__(self, timeout_s: float, grace_steps: int = 3):
        self.timeout_s = timeout_s
        self.grace = grace_steps
        self._last = time.monotonic()
        self._steps = 0
        self.tripped = False

    def tick(self) -> bool:
        now = time.monotonic()
        self._steps += 1
        if self._steps > self.grace and now - self._last > self.timeout_s:
            self.tripped = True
        self._last = now
        return self.tripped
