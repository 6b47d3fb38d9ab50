"""Replayable JSONL incident traces of the serving layer and the fleet.

Counterpart of ``repro.serve.trace``. Every decision the batcher and the
fleet control plane make -- submit, flush, fault, retry, shed, resolve,
canary observation, breach, retrain progress, hot-swap, degrade -- appends
one JSON-stable event to a :class:`Trace` (the batcher's ``on_event`` hook
feeds it; ``serve.fleet.FleetRuntime`` writes its own). :func:`compare`
holds two traces event for event, e.g. the port's against the reference's
on one seeded schedule, with every served output reduced to its
:func:`digest`; :func:`replay` re-drives a freshly built fleet through the
recorded *input* events (submit / set-condition / tick / drain) and
requires every re-emitted event to match the recording bit for bit.

Replay is cheap because every source of nondeterminism is seed-threaded:
canary noise keys fold ``(canary_seed, trial)``, deploy-QAT steps fold
``(base_key, step)`` (``core.deploy_qat.train_step_key``), fault decisions
are pure functions of ``(plan_seed, draw)`` (:mod:`.faults`), and request
payloads derive from recorded ``RequestSpec`` seeds. On the card the
retrain's backward must also be deterministic (cuDNN's deterministic
algorithms, ``torch.backends.cudnn.deterministic``).

Events are normalized (:func:`jsonable`) at emit time, so the in-memory
comparison equals the comparison after a JSONL round-trip.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

#: Event types that are *inputs* to the runtime (the recorded schedule).
#: Everything else is a decision/output the replay must reproduce.
DRIVER_EVENTS = ("submit", "set-condition", "tick", "drain")


def jsonable(x):
    """Normalize to JSON-stable python types (tuples->lists, np scalars
    ->python, arrays->digests) so emit-time events == loaded events."""
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.ndarray):
        return digest(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return jsonable(dataclasses.asdict(x))
    return x


def digest(arr) -> str:
    """Short content digest of an array: dtype + shape + raw bytes.

    The trace records one digest per served output — enough to prove a
    replay reproduced every result bit-exactly without storing tensors.
    """
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.blake2s(digest_size=10)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


class Trace:
    """An append-only event log with JSONL persistence."""

    def __init__(self, events: Optional[List[Dict]] = None):
        self.events: List[Dict] = list(events or [])

    def emit(self, etype: str, **fields) -> Dict:
        evt = {"e": etype, **jsonable(fields)}
        self.events.append(evt)
        return evt

    def of_type(self, etype: str) -> List[Dict]:
        return [e for e in self.events if e["e"] == etype]

    @property
    def config(self) -> Dict:
        """The run's config event (by convention the first event)."""
        for e in self.events:
            if e["e"] == "config":
                return e
        raise ValueError("trace has no config event — cannot replay")

    def save(self, path: str):
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e, sort_keys=True) + "\n")

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls([json.loads(line) for line in f if line.strip()])

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[Dict]:
        return iter(self.events)


@dataclasses.dataclass
class ReplayReport:
    """Outcome of replaying a trace against a rebuilt runtime."""

    bit_exact: bool
    n_events: int              # events compared
    divergence_index: Optional[int] = None
    expected: Optional[Dict] = None
    got: Optional[Dict] = None

    def summary(self) -> str:
        if self.bit_exact:
            return f"replay bit-exact over {self.n_events} events"
        return (f"replay DIVERGED at event {self.divergence_index}: "
                f"expected {self.expected!r}, got {self.got!r}")


def _canon(evt: Dict) -> Dict:
    """JSON round-trip so float repr / container types compare stably."""
    return json.loads(json.dumps(evt, sort_keys=True))


def compare(recorded: Trace, fresh: Trace) -> ReplayReport:
    """Event-for-event comparison; first mismatch wins."""
    n = max(len(recorded.events), len(fresh.events))
    for i in range(n):
        a = _canon(recorded.events[i]) if i < len(recorded.events) else None
        b = _canon(fresh.events[i]) if i < len(fresh.events) else None
        if a != b:
            return ReplayReport(False, n, i, a, b)
    return ReplayReport(True, n)


def replay(trace: Trace,
           build_fleet: Callable[[Dict, Trace], object]) -> ReplayReport:
    """Reproduce a recorded fleet incident bit for bit.

    ``build_fleet(config_event, fresh_trace)`` must rebuild the runtime the
    way the original run did: same model factories, same SLOs, same fault
    plan, registered in the same order, emitting into ``fresh_trace``. The
    replay then walks the recorded input events (``DRIVER_EVENTS``) in
    order, re-running each against the rebuilt runtime, and compares the
    fresh trace against the recording.

    The trace pins every seed and the digests of every stack, probe and
    output, but not the model *weights* themselves: a drifted factory is
    caught at the first ``register`` event (stack digest mismatch), not
    silently accepted.
    """
    from .fleet import RequestSpec  # local import: fleet imports trace
    fresh = Trace()
    fleet = build_fleet(trace.config, fresh)
    for evt in trace.events:
        et = evt["e"]
        if et == "submit":
            fleet.submit(evt["model"],
                         [RequestSpec(rid=s["rid"], seed=s["seed"],
                                      shape=tuple(s["shape"]),
                                      dtype=s["dtype"])
                          for s in evt["specs"]])
        elif et == "set-condition":
            nc = evt["nc"]
            fleet.set_condition(evt["model"],
                                None if nc is None else tuple(nc))
        elif et == "tick":
            fleet.tick()
        elif et == "drain":
            fleet.drain()
    return compare(trace, fresh)
