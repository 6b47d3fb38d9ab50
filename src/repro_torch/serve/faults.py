"""Seeded fault injection at the serving device boundary.

Counterpart of ``repro.serve.faults``, in numpy alone: every draw equals
the reference's, in value and in order. A flush dispatch can fail outright,
a dispatch-ahead result can come back late ("stuck" in the in-flight
window), and a noise canary's agreement observation can be corrupted on its
way back to a control plane. This module injects exactly those three fault
classes, so the batcher's retry/backoff path and the window's head-of-line
behavior can be exercised deterministically.

Determinism contract: every fault decision is a pure function of
``(plan.seed, draw_index)``; the oracle only keeps a draw counter, and
every query consumes a FIXED number of draws regardless of outcome. The
same schedule against a fresh ``FaultyDevice`` with the same plan therefore
reproduces the identical fault sequence.

The injected failure happens *before* the step runs (a flush fate of
``fail`` means the dispatch never reached the device), so a faulted flush
leaves no device-side state and the batcher can requeue the batch
losslessly.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule + the bounded retry/backoff policy.

    Probabilities are per-decision: ``p_flush_fail`` per flush dispatch,
    ``p_stuck`` per successful dispatch-ahead flush (the result sits in
    the window for 1..``max_stuck_ticks`` extra ticks), and
    ``p_canary_corrupt`` per canary observation (the agreement reading
    is replaced by junk — the control plane's median filter has to ride
    it out). ``max_retries`` bounds consecutive failed dispatch attempts
    per bucket before the batch is shed with a structured error;
    ``backoff_ticks`` scales the per-attempt backoff (attempt k waits
    ``max(1, backoff_ticks * k)`` ticks before the bucket is eligible
    again).
    """

    seed: int = 0
    p_flush_fail: float = 0.0
    p_stuck: float = 0.0
    max_stuck_ticks: int = 2
    p_canary_corrupt: float = 0.0
    max_retries: int = 3
    backoff_ticks: int = 1

    def __post_init__(self):
        for name in ("p_flush_fail", "p_stuck", "p_canary_corrupt"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name}={v} must be in [0, 1]")
        if self.max_retries < 0 or self.backoff_ticks < 0 \
                or self.max_stuck_ticks < 0:
            raise ValueError("max_retries/backoff_ticks/max_stuck_ticks "
                             "must be >= 0")

    @property
    def active(self) -> bool:
        return (self.p_flush_fail > 0 or self.p_stuck > 0
                or self.p_canary_corrupt > 0)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FlushFate:
    """The oracle's verdict for one flush dispatch attempt."""
    fail: bool
    stuck_ticks: int   # extra ticks the result sits in the window
    draw: int          # first draw index consumed (for trace forensics)


class FaultyDevice:
    """Deterministic fault oracle shared by a fleet's batchers + canaries.

    Decision ``n`` is ``np.random.default_rng((seed, n)).random()`` — a
    stateless function of the plan seed and the draw counter, so the
    whole fault sequence replays bit-exactly from the recorded plan.
    ``flush_fate`` always consumes 3 draws and ``canary_fate`` always 2,
    keeping the counter aligned between a live run and its replay even
    when outcomes differ branch-wise.
    """

    FLUSH_DRAWS = 3
    CANARY_DRAWS = 2

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._draw = 0

    @property
    def max_retries(self) -> int:
        return self.plan.max_retries

    @property
    def backoff_ticks(self) -> int:
        return self.plan.backoff_ticks

    @property
    def draws(self) -> int:
        """Total decisions consumed so far (trace/replay alignment)."""
        return self._draw

    def _u(self) -> float:
        u = float(np.random.default_rng((self.plan.seed, self._draw)).random())
        self._draw += 1
        return u

    def flush_fate(self, *, tick: int = -1) -> FlushFate:
        """Fate of one flush dispatch attempt (3 draws, always)."""
        first = self._draw
        u_fail, u_stuck, u_len = self._u(), self._u(), self._u()
        if u_fail < self.plan.p_flush_fail:
            return FlushFate(True, 0, first)
        stuck = 0
        if self.plan.max_stuck_ticks > 0 and u_stuck < self.plan.p_stuck:
            stuck = 1 + int(u_len * self.plan.max_stuck_ticks)
            stuck = min(stuck, self.plan.max_stuck_ticks)
        return FlushFate(False, stuck, first)

    def canary_fate(self):
        """(corrupted, junk_value) for one canary observation (2 draws).

        When ``corrupted`` the control plane should see ``junk_value``
        (uniform in [0, 1)) instead of the measured agreement.
        """
        u_c, u_v = self._u(), self._u()
        return (u_c < self.plan.p_canary_corrupt, u_v)
