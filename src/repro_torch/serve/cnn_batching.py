"""Shape-bucketed request batching for integer CNN inference on the card.

Counterpart of ``repro.serve.cnn_batching``. Everything the scheduler
decides is the reference's, line for line, so a seeded schedule gives the
same event stream, the same outputs, wait and finish ticks, generations and
``stats``: the ladder frontend and the (shape, dtype) buckets; power-of-two
batch slots capped at ``max_batch``; the ``(age, fill)`` candidate rank;
sync mode's one flush per tick against dispatch-ahead's free-window budget;
least-loaded lane routing and the ``(ready_tick, dispatch_tick, lane)``
resolve merge; backoff, retry and shed at the fault boundary
(:mod:`.faults`), ``shed_expired``; the GC of dead buckets; the wait and
in-flight-age stats; ``swap_apply_fn`` with generation stamps; and the
``on_event`` stream (flush / fault / retry / shed / resolve / swap). The
reference's module docstring is the full account of that policy.

What differs is the step, which the reference jits once per
``(bucket, slots)`` signature with the input buffer donated:

  * **One CUDA graph per signature and lane.** On a CUDA lane each clean
    flush replays a graph captured at the first flush of its
    ``(generation, bucket, slots)``, after one warm-up call on the lane's
    stream (the kernels' libraries are built and loaded at first use, never
    inside a capture). The graph reads a static device input and writes a
    static device output. A lane's graphs share one memory pool and replay
    on the lane's own stream only, so they never run concurrently. Their
    count is bounded as jit's is: ``n_signatures`` per lane.
  * **Pinned staging.** A flush packs its padded batch straight into a
    pinned host buffer, one per in-flight window slot, each guarded by an
    event recorded after the host-to-device copy that reads it (a buffer is
    refilled only once that copy has completed). The copy into the graph's
    input is asynchronous on the lane's stream; right after the replay the
    output goes back by an asynchronous copy into a pinned buffer of the
    flush's own, so the next replay of the same graph cannot overwrite an
    unread result. ``_finish`` waits on the flush's event and hands out a
    copy of each row: in sync mode at once, in dispatch-ahead mode at
    resolve time, so the host packs the next batch while the card runs.
  * **Replica lanes** are CUDA streams on the stack's device (the
    ``device`` attribute of ``apply_fn``, as ``models.kws.int_serve_fn``
    and ``models.darknet.int_serve_fn`` set it), or each on its own device
    where ``replica_devices`` names them. Clean outputs are invariant to
    the lane count.
  * **The noise canary** draws each flush's key as
    ``prng.fold_in(prng.PRNGKey(noise_seed), trial)``, bit-exact with the
    reference's ``jax.random.fold_in(jax.random.key(noise_seed), trial)``.
    Noisy flushes run ``apply_fn(x, noise=..., rng=key)`` eagerly on the
    lane's stream, from the same pinned staging: the code perturbation
    builds its counters from host integers, which a graph would freeze.
  * **CPU lanes** (a stack or ``apply_fn`` on ``device="cpu"``, as the
    tests run it) call the step eagerly on a CPU tensor. A CUDA lane never
    runs on the CPU, and a capture, launch or copy that fails raises:
    nothing retries eagerly or elsewhere.

``step_stats`` records how each flush ran (``graph_flushes``,
``eager_flushes``), the captures and their time, and the graphs alive on
each lane.

Not ported: ``mesh=`` (the reference's big-batch sharding through
``models.sharding.serving_constrain``; passing one raises), the shared
``step_fn`` (it shares the reference's jit cache; graphs belong to a lane)
and the kernels' autotune replica scope (``fq_conv.replica_scope``, which
comes with the conv tile policy).
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import prng
from ..core.noise import NoiseConfig
from ..device import resolve_device
from .shape_ladder import ShapeLadder


@dataclasses.dataclass
class CNNRequest:
    rid: int
    x: np.ndarray                    # one sample, no batch dim
    out: Optional[np.ndarray] = None
    done: bool = False
    # set by the batcher:
    x_served: Optional[np.ndarray] = None  # ladder-normalized payload
    submit_tick: int = -1
    wait_ticks: int = -1                   # submit -> dispatch, in ticks
    finish_tick: int = -1                  # resolve/shed tick
    generation: int = -1                   # model generation that served it
    error: Optional[Dict] = None           # structured shed error, else None


@dataclasses.dataclass
class InflightFlush:
    """A dispatched-but-unfetched flush parked on a lane's window."""
    key: Tuple
    reqs: List[CNNRequest]
    dev_out: object                  # the flush's pending result
    dispatch_tick: int
    generation: int = 0              # model generation at dispatch
    ready_tick: int = 0              # dispatch_tick + 1 + injected stuck ticks
    replica: int = 0                 # lane that dispatched it


class _Result:
    """A flush's output: a host tensor, valid once ``done`` (an event
    recorded after its device-to-host copy; None on a CPU lane) has
    completed."""

    def __init__(self, out: torch.Tensor, done=None):
        self.out = out
        self.done = done

    def fetch(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.out.numpy()


@dataclasses.dataclass
class _Graph:
    """One captured step: replaying ``graph`` reads ``x`` and writes ``y``."""
    graph: object
    x: torch.Tensor
    y: torch.Tensor


class _Staging:
    """Pinned host buffers, one per in-flight window slot, each guarded by
    an event recorded after the host-to-device copy that reads it."""

    def __init__(self, n: int):
        self._bufs: List[Optional[torch.Tensor]] = [None] * n
        self._events: List[Optional[torch.cuda.Event]] = [None] * n
        self._next = 0

    def take(self, shape: Tuple[int, ...], dtype: np.dtype):
        """(slot, a pinned tensor of ``shape`` and ``dtype``) once the slot's
        last copy has completed."""
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        if self._events[i] is not None:
            self._events[i].synchronize()
        nbytes = math.prod(shape) * dtype.itemsize
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = self._bufs[i] = torch.empty(nbytes, dtype=torch.uint8,
                                              pin_memory=True)
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        return i, buf[:nbytes].view(tdtype).view(shape)

    def guard(self, i: int, stream) -> None:
        ev = torch.cuda.Event()
        ev.record(stream)
        self._events[i] = ev


@dataclasses.dataclass
class ReplicaLane:
    """One replica execution lane: its step (the served closure), its
    device and, on CUDA, its stream, graph pool, graphs and staging; and a
    bounded in-flight window."""
    rid: int
    step: Callable
    device: torch.device
    pinned: object = None            # the replica_devices entry, if any
    inflight: Deque[InflightFlush] = dataclasses.field(default_factory=deque)
    flushes: int = 0                 # successful dispatches, lifetime
    served: int = 0
    stuck: int = 0
    inflight_peak: int = 0
    stream: object = None            # torch.cuda.Stream on a CUDA lane
    pool: object = None              # the lane's graph memory pool
    graphs: Dict[Tuple, _Graph] = dataclasses.field(default_factory=dict)
    staging: Optional[_Staging] = None


def batch_bucket(n: int, max_batch: int) -> int:
    """Smallest power-of-two slot count that fits n, capped at max_batch."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


_WAIT_HIST_LEN = 4096    # lifetime wait samples kept per bucket
_WAIT_HIST_BUCKETS = 128  # distinct buckets tracked; overflow aggregates


class CNNBatcher:
    """The reference's batcher over graph-replayed (CUDA) or eager (CPU)
    steps; see the module docstring.

    ``apply_fn`` maps a batched input tensor to batched outputs (e.g. the
    closure from ``models.kws.int_serve_fn`` / ``models.darknet
    .int_serve_fn``); with a noise canary it must accept ``(x, noise=...,
    rng=...)``. ``replica_apply_fns`` gives each of ``n_replicas`` lanes its
    own closure; ``replica_devices`` places each lane on a device of its
    own (default: the closure's ``device``, else the current CUDA device).
    ``device`` is the fault boundary (a ``serve.faults.FaultyDevice``), as
    in the reference.
    """

    def __init__(self, apply_fn: Callable, *, max_batch: int = 8,
                 max_wait_ticks: int = 2,
                 ladder: Optional[ShapeLadder] = None,
                 dispatch_ahead: bool = False, max_inflight: int = 2,
                 noise_config: Optional[NoiseConfig] = None,
                 noise_seed: int = 0,
                 device=None,
                 on_event: Optional[Callable[[str, Dict], None]] = None,
                 n_replicas: int = 1,
                 replica_apply_fns: Optional[Sequence[Callable]] = None,
                 replica_devices: Optional[Sequence] = None,
                 mesh=None,
                 wait_window: int = 256):
        assert max_batch >= 1 and max_inflight >= 1
        assert n_replicas >= 1 and wait_window >= 1
        if mesh is not None:
            raise ValueError("mesh= (big-batch sharding over a serving mesh, "
                             "models.sharding.serving_constrain) is not "
                             "ported; serve with replica lanes instead")
        self.apply_fn = apply_fn
        self.max_batch = max_batch
        self.max_wait_ticks = max_wait_ticks
        self.ladder = ladder
        self.dispatch_ahead = dispatch_ahead
        self.max_inflight = max_inflight         # PER replica lane
        self.wait_window = wait_window
        self.noise_config = noise_config
        self._noisy = noise_config is not None and noise_config.enabled
        self._noise_key = prng.PRNGKey(noise_seed) if self._noisy else None
        self._device = device          # serve.faults boundary (or None)
        self._on_event = on_event
        self.generation = 0            # bumped by every swap_apply_fn
        self._queues: Dict[Tuple, List[CNNRequest]] = {}
        self._age: Dict[Tuple, int] = {}
        self._backoff: Dict[Tuple, int] = {}        # bucket -> eligible tick
        self._flush_attempts: Dict[Tuple, int] = {}  # consecutive faults
        self._tick_no = 0
        self._replica_apply_fns = list(replica_apply_fns) \
            if replica_apply_fns is not None else None
        if self._replica_apply_fns is not None \
                and len(self._replica_apply_fns) != n_replicas:
            raise ValueError(f"replica_apply_fns has "
                             f"{len(self._replica_apply_fns)} entries for "
                             f"{n_replicas} replicas")
        devs = list(replica_devices) if replica_devices is not None \
            else [None] * n_replicas
        if len(devs) != n_replicas:
            raise ValueError(f"replica_devices has {len(devs)} entries for "
                             f"{n_replicas} replicas")
        fns = self._replica_apply_fns or [apply_fn] * n_replicas
        self._lanes = [self._make_lane(i, fn, devs[i])
                       for i, fn in enumerate(fns)]
        self._signatures: set = set()
        self._wait_hist: Dict[str, Deque[int]] = {}
        self._wait_recent: Dict[str, Deque[int]] = {}
        self._wait_stats_cache: Dict[bool, Optional[Dict]] = {
            False: None, True: None}
        self._inflight_age_sum = 0
        self._inflight_age_n = 0
        self._counters = {
            "flushes": 0, "served": 0, "padded_rows": 0,
            "ladder_hits": 0, "ladder_normalized": 0, "ladder_misses": 0,
            "window_waits": 0, "inflight_peak": 0, "noise_trials": 0,
            "flush_faults": 0, "retries": 0, "stuck_flushes": 0, "shed": 0,
            "inflight_age_max": 0,
        }
        self._steps = {"graph_flushes": 0, "eager_flushes": 0,
                       "captures": 0, "capture_s": 0.0}

    def _emit(self, etype: str, **kw):
        if self._on_event is not None:
            self._on_event(etype, kw)

    def _make_lane(self, rid: int, fn: Callable, pinned) -> ReplicaLane:
        dev = resolve_device(pinned if pinned is not None
                             else getattr(fn, "device", None))
        lane = ReplicaLane(rid=rid, step=fn, device=dev, pinned=pinned)
        if dev.type == "cuda":
            lane.stream = torch.cuda.Stream(device=dev)
            lane.pool = torch.cuda.graph_pool_handle()
            lane.staging = _Staging(self.max_inflight)
        return lane

    def swap_apply_fn(self, apply_fn, *, replica_apply_fns=None):
        """Hot-swap the served model between flushes.

        As the reference's: queued requests serve under the new model on
        their next flush, results already in a dispatch-ahead window were
        computed under the old one and resolve normally. The swap bumps
        ``generation`` once, then installs the new closure lane by lane,
        each install emitting a replica-tagged ``swap`` event. A lane's
        graphs of an older generation are released once none of its
        in-flight flushes was dispatched under that generation (their
        outputs are copied out by then); the new closure's graphs are
        captured at first flush.
        """
        if replica_apply_fns is not None \
                and len(replica_apply_fns) != len(self._lanes):
            raise ValueError(f"replica_apply_fns has "
                             f"{len(replica_apply_fns)} entries for "
                             f"{len(self._lanes)} replicas")
        self.apply_fn = apply_fn
        self._replica_apply_fns = list(replica_apply_fns) \
            if replica_apply_fns is not None else None
        self.generation += 1
        for lane in self._lanes:
            lane.step = apply_fn if self._replica_apply_fns is None \
                else self._replica_apply_fns[lane.rid]
            self._release_graphs(lane)
            self._emit("swap", generation=self.generation,
                       tick=self._tick_no, replica=lane.rid)

    # -- request intake -----------------------------------------------------

    def submit(self, reqs: List[CNNRequest]):
        prepared, seen = [], set()  # validate + normalize the WHOLE list
        for r in reqs:  # before any mutation: a mid-list failure
            # (resubmission, duplicate, malformed payload) must never
            # partially enqueue the call
            if id(r) in seen or r.x_served is not None or r.done:
                raise ValueError(f"request {r.rid} was already submitted")
            seen.add(id(r))
            x = np.asarray(r.x)
            xn = self.ladder.normalize(x) if self.ladder is not None else x
            prepared.append((r, x, xn))
        for r, x, xn in prepared:
            if self.ladder is not None:
                if xn is None:
                    self._counters["ladder_misses"] += 1
                else:
                    self._counters["ladder_hits"] += 1
                    if xn.shape != x.shape:
                        self._counters["ladder_normalized"] += 1
                    x = xn
            r.x_served = x
            r.submit_tick = self._tick_no
            key = (x.shape, x.dtype.str)
            self._queues.setdefault(key, []).append(r)
            self._age.setdefault(key, 0)

    def pending(self) -> int:
        """Requests queued but not yet dispatched."""
        return sum(len(q) for q in self._queues.values())

    @property
    def _inflight(self) -> List[InflightFlush]:
        """All in-flight flushes across lanes, oldest dispatch first (a
        read-only merged view)."""
        out = [f for lane in self._lanes for f in lane.inflight]
        out.sort(key=lambda f: (f.dispatch_tick, f.replica))
        return out

    @property
    def in_flight(self) -> int:
        """Requests dispatched but not yet resolved (dispatch-ahead only)."""
        return sum(len(f.reqs) for lane in self._lanes
                   for f in lane.inflight)

    def _inflight_flushes(self) -> int:
        return sum(len(lane.inflight) for lane in self._lanes)

    def _free_window(self) -> int:
        return sum(max(0, self.max_inflight - len(lane.inflight))
                   for lane in self._lanes)

    def outstanding(self) -> int:
        return self.pending() + self.in_flight

    # -- the step ------------------------------------------------------------

    def _route(self) -> ReplicaLane:
        """Least-loaded replica lane, deterministically: min in-flight
        depth, then fewest lifetime flushes (round-robin under sync
        mode's always-empty windows), then lowest lane id."""
        return min(self._lanes,
                   key=lambda l: (len(l.inflight), l.flushes, l.rid))

    def _stage(self, lane: ReplicaLane, shape: Tuple[int, ...],
               dtype: np.dtype):
        """(slot, host tensor to pack the padded batch into): a pinned
        staging buffer on a CUDA lane, zeros on a CPU lane."""
        if lane.staging is None:
            return None, torch.from_numpy(np.zeros(shape, dtype=dtype))
        return lane.staging.take(shape, dtype)

    def _capture(self, lane: ReplicaLane, x: torch.Tensor) -> _Graph:
        """Warm the lane's step up once on the lane's stream, then capture
        one call of it reading a static input shaped like ``x``."""
        t0 = time.perf_counter()
        static_x = torch.zeros(x.shape, dtype=x.dtype, device=lane.device)
        lane.step(static_x)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=lane.pool, stream=lane.stream):
            y = lane.step(static_x)
        self._steps["captures"] += 1
        self._steps["capture_s"] += time.perf_counter() - t0
        return _Graph(graph, static_x, y)

    def _dispatch(self, lane: ReplicaLane, sig: Tuple, slot, x: torch.Tensor,
                  key_n) -> _Result:
        """Run one packed batch on ``lane``: eagerly on a CPU lane; on a
        CUDA lane, the pinned batch is copied in on the lane's stream, the
        signature's graph replays (captured now if new), or the step runs
        eagerly under noise, and the output is copied back to pinned
        memory behind an event."""
        noisy = {} if key_n is None else dict(noise=self.noise_config,
                                              rng=key_n.to(lane.device))
        with torch.no_grad():
            if lane.stream is None:
                self._steps["eager_flushes"] += 1
                return _Result(lane.step(x, **noisy))
            with torch.cuda.device(lane.device), \
                    torch.cuda.stream(lane.stream):
                if key_n is None:
                    g = lane.graphs.get(sig)
                    if g is None:
                        g = lane.graphs[sig] = self._capture(lane, x)
                    g.x.copy_(x, non_blocking=True)
                    lane.staging.guard(slot, lane.stream)
                    g.graph.replay()
                    y = g.y
                    self._steps["graph_flushes"] += 1
                else:
                    xd = torch.empty(x.shape, dtype=x.dtype,
                                     device=lane.device)
                    xd.copy_(x, non_blocking=True)
                    lane.staging.guard(slot, lane.stream)
                    y = lane.step(xd, **noisy)
                    self._steps["eager_flushes"] += 1
                out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                out.copy_(y, non_blocking=True)
                done = torch.cuda.Event()
                done.record(lane.stream)
        return _Result(out, done)

    def _release_graphs(self, lane: ReplicaLane):
        """Drop the lane's graphs of generations that are neither current
        nor held by one of its in-flight flushes."""
        live = {self.generation} | {f.generation for f in lane.inflight}
        for sig in [s for s in lane.graphs if s[0] not in live]:
            del lane.graphs[sig]

    # -- flushing -----------------------------------------------------------

    def _flush(self, key: Tuple, reqs: List[CNNRequest]) -> int:
        """Dispatch one padded batch to the least-loaded lane. Returns
        #requests COMPLETED now (sync: all of them; dispatch-ahead: 0,
        they resolve later).

        With a fault boundary installed the dispatch can fail BEFORE
        reaching the device: the batch requeues at the front of its
        bucket under backoff, or -- past the bounded retry budget -- sheds
        with a structured error."""
        shape, dtype = key
        stuck = 0
        if self._device is not None:
            fate = self._device.flush_fate(tick=self._tick_no)
            if fate.fail:
                return self._flush_fault(key, reqs)
            stuck = fate.stuck_ticks if self.dispatch_ahead else 0
        lane = self._route()
        slots = batch_bucket(len(reqs), self.max_batch)
        slot, xt = self._stage(lane, (slots,) + shape, np.dtype(dtype))
        x = xt.numpy()
        for i, r in enumerate(reqs):
            x[i] = r.x_served
            r.wait_ticks = self._tick_no - r.submit_tick
            r.generation = self.generation
        x[len(reqs):] = 0  # a reused staging buffer: pad rows are zeros
        self._record_waits(key, reqs)
        self._signatures.add((key, slots))
        self._counters["flushes"] += 1
        self._counters["padded_rows"] += slots - len(reqs)
        lane.flushes += 1
        self._age[key] = 0  # every flush restarts the bucket's wait clock
        self._flush_attempts.pop(key, None)  # success resets retry budget
        key_n = None
        if self._noisy:
            # one fresh key per flush: noisy trials differ flush-to-flush
            # but the whole canary run replays bit-exact from noise_seed
            key_n = prng.fold_in(self._noise_key,
                                 self._counters["noise_trials"])
            self._counters["noise_trials"] += 1
        dev = self._dispatch(lane, (self.generation, key, slots), slot, xt,
                             key_n)
        self._emit("flush", key=key, tick=self._tick_no, n=len(reqs),
                   slots=slots, generation=self.generation, stuck=stuck,
                   replica=lane.rid)
        if self.dispatch_ahead:
            if stuck:
                self._counters["stuck_flushes"] += 1
                lane.stuck += 1
            lane.inflight.append(
                InflightFlush(key, reqs, dev, self._tick_no,
                              generation=self.generation,
                              ready_tick=self._tick_no + 1 + stuck,
                              replica=lane.rid))
            lane.inflight_peak = max(lane.inflight_peak, len(lane.inflight))
            self._counters["inflight_peak"] = max(
                self._counters["inflight_peak"], self._inflight_flushes())
            return 0
        n = self._finish(reqs, dev)
        lane.served += n
        self._emit("resolve", key=key, tick=self._tick_no, reqs=reqs,
                   generation=self.generation, age=0, replica=lane.rid)
        return n

    def _flush_fault(self, key: Tuple, reqs: List[CNNRequest]) -> int:
        """A dispatch the fault layer failed: bounded retry w/ backoff,
        then shed. The step never ran, so requeueing is lossless."""
        attempt = self._flush_attempts.get(key, 0) + 1
        self._flush_attempts[key] = attempt
        self._counters["flush_faults"] += 1
        self._emit("fault", kind="flush-fail", key=key, tick=self._tick_no,
                   attempt=attempt)
        if attempt > self._device.max_retries:
            self._flush_attempts.pop(key, None)
            self._backoff.pop(key, None)
            self._shed(reqs, code="flush-fault", attempts=attempt)
            return 0
        self._queues.setdefault(key, [])[:0] = reqs  # front: order kept
        self._age.setdefault(key, 0)
        until = self._tick_no + max(1, self._device.backoff_ticks * attempt)
        self._backoff[key] = until
        self._counters["retries"] += 1
        self._emit("retry", key=key, tick=self._tick_no, attempt=attempt,
                   backoff_until=until)
        return 0

    def _shed(self, reqs: List[CNNRequest], *, code: str, **details):
        """Shed requests with a structured error (exactly-once: ``done``
        is set, so a later serve attempt would raise double-served)."""
        for r in reqs:
            if r.done:
                raise RuntimeError(f"request {r.rid} double-served (shed)")
            r.error = {"code": code, "rid": r.rid, "tick": self._tick_no,
                       "submit_tick": r.submit_tick, **details}
            r.finish_tick = self._tick_no
            r.done = True
            self._counters["shed"] += 1
            self._emit("shed", rid=r.rid, code=code, tick=self._tick_no,
                       submit_tick=r.submit_tick, **details)

    def shed_expired(self, max_age_ticks: int) -> List[CNNRequest]:
        """Shed queued requests older than ``max_age_ticks`` (submit ->
        now) with a structured ``deadline`` error, instead of letting
        them stall behind backoff or a full window. Returns the shed
        requests; in-flight results are never shed (they resolve)."""
        out = []
        for key, q in self._queues.items():
            keep = []
            for r in q:
                age = self._tick_no - r.submit_tick
                if age > max_age_ticks:
                    out.append(r)
                else:
                    keep.append(r)
            self._queues[key] = keep
        self._shed(out, code="deadline", deadline_ticks=max_age_ticks)
        return out

    def _finish(self, reqs: List[CNNRequest], dev: _Result) -> int:
        y = dev.fetch()
        for i, r in enumerate(reqs):
            if r.done:
                raise RuntimeError(f"request {r.rid} double-served")
            r.out = y[i].copy()
            r.finish_tick = self._tick_no
            r.done = True
        self._counters["served"] += len(reqs)
        return len(reqs)

    def _resolve_lane(self, lane: ReplicaLane) -> int:
        """Pop + fetch the lane's head flush, recording its window age."""
        f = lane.inflight.popleft()
        age = self._tick_no - f.dispatch_tick
        self._counters["inflight_age_max"] = max(
            self._counters["inflight_age_max"], age)
        self._inflight_age_sum += age
        self._inflight_age_n += 1
        n = self._finish(f.reqs, f.dev_out)
        lane.served += n
        self._release_graphs(lane)
        self._emit("resolve", key=f.key, tick=self._tick_no, reqs=f.reqs,
                   generation=f.generation, age=age, replica=f.replica)
        return n

    def _resolve_one(self) -> int:
        """Fetch the globally-oldest in-flight head, ready or not (drain
        / window back-pressure: the host blocks on it anyway)."""
        lane = min((l for l in self._lanes if l.inflight),
                   key=lambda l: (l.inflight[0].dispatch_tick, l.rid))
        return self._resolve_lane(lane)

    def _resolve_older_than(self, tick: int) -> int:
        """Fetch in-flight results that are ready by ``tick`` (the device
        had the inter-tick interval to run them; a stuck result's
        ``ready_tick`` was pushed out by the fault layer). Lanes merge in
        (ready_tick, dispatch_tick, lane id) order -- deterministic."""
        n = 0
        while True:
            best = None
            for lane in self._lanes:
                if lane.inflight and lane.inflight[0].ready_tick <= tick:
                    rank = (lane.inflight[0].ready_tick,
                            lane.inflight[0].dispatch_tick, lane.rid)
                    if best is None or rank < best[0]:
                        best = (rank, lane)
            if best is None:
                return n
            n += self._resolve_lane(best[1])

    def _candidate(self) -> Optional[Tuple]:
        """Highest-priority flush candidate by (age, fill-ratio), or None."""
        best, best_rank = None, None
        for key, q in self._queues.items():
            if not q:
                continue
            if self._backoff.get(key, 0) > self._tick_no:
                continue  # faulted bucket still backing off
            fill = len(q) / self.max_batch
            if fill < 1.0 and self._age[key] <= self.max_wait_ticks:
                continue
            rank = (self._age[key], fill)
            if best is None or rank > best_rank:
                best, best_rank = key, rank
        return best

    def _gc_buckets(self):
        """Drop empty bucket state so high shape cardinality stays bounded."""
        for key in [k for k, q in self._queues.items() if not q]:
            del self._queues[key]
            self._age.pop(key, None)
            self._backoff.pop(key, None)
            self._flush_attempts.pop(key, None)
        for key in [k for k, t in self._backoff.items()
                    if t <= self._tick_no]:
            del self._backoff[key]  # expired backoff, state stays bounded

    def tick(self) -> int:
        """One host scheduling quantum. Returns #requests completed.

        Resolve earlier-tick in-flight results, age the buckets, then
        flush the ranked candidates within this tick's budget: one
        blocking flush (sync) or the free in-flight window slots summed
        across every replica lane (dispatch-ahead)."""
        served = 0
        if self.dispatch_ahead:
            served += self._resolve_older_than(self._tick_no)
            budget = self._free_window()
        else:
            budget = 1
        for key, q in self._queues.items():
            if q:
                self._age[key] += 1
        while budget > 0:
            key = self._candidate()
            if key is None:
                break
            q = self._queues[key]
            take = min(len(q), self.max_batch)
            self._queues[key] = q[take:]
            served += self._flush(key, q[:take])
            budget -= 1
        if self.dispatch_ahead and self._candidate() is not None:
            # a tick that ended with candidates still back-pressured
            # behind the full window(s) (ticks-under-pressure, not a
            # per-candidate count)
            self._counters["window_waits"] += 1
        self._gc_buckets()
        self._tick_no += 1
        return served

    def drain(self) -> int:
        """Flush every pending request and resolve every in-flight result
        now (shutdown / end of load). Returns #requests completed.

        Dispatch faults during drain retry immediately (no ticks are
        advancing to serve a backoff): a faulted batch lands back in its
        queue and the outer loop re-attempts it until it dispatches or
        exhausts the retry budget and sheds."""
        served = 0
        while True:
            keys = [k for k, q in self._queues.items() if q]
            if not keys:
                break
            for key in keys:
                q, self._queues[key] = self._queues[key], []
                while q:
                    batch, q = q[:self.max_batch], q[self.max_batch:]
                    if self.dispatch_ahead and self._free_window() == 0:
                        served += self._resolve_one()  # window back-pressure
                    served += self._flush(key, batch)
        while any(lane.inflight for lane in self._lanes):
            served += self._resolve_one()
        self._gc_buckets()
        return served

    @property
    def n_signatures(self) -> int:
        """Distinct (shape, slots) signatures dispatched so far."""
        return len(self._signatures)

    @property
    def n_graphs(self) -> int:
        """CUDA graphs alive across lanes."""
        return sum(len(lane.graphs) for lane in self._lanes)

    @property
    def step_stats(self) -> Dict:
        """How the flushes ran: replayed graphs or eager steps; the
        captures, their time (warm-up included) and the graphs alive on
        each lane."""
        return {**self._steps,
                "graphs": [len(lane.graphs) for lane in self._lanes]}

    # -- observability ------------------------------------------------------

    def _record_waits(self, key: Tuple, reqs: List[CNNRequest]):
        label = f"{key[0]}/{np.dtype(key[1]).name}"
        if label not in self._wait_hist and \
                len(self._wait_hist) >= _WAIT_HIST_BUCKETS:
            label = "<overflow>"
        hist = self._wait_hist.setdefault(label, deque(maxlen=_WAIT_HIST_LEN))
        recent = self._wait_recent.setdefault(
            label, deque(maxlen=self.wait_window))
        waits = [r.wait_ticks for r in reqs]
        hist.extend(waits)
        recent.extend(waits)
        self._wait_stats_cache = {False: None, True: None}

    def wait_stats(self, *, window: bool = False
                   ) -> Dict[str, Dict[str, float]]:
        """Per-bucket submit-to-dispatch wait percentiles, in ticks;
        ``window=True`` over only the last ``wait_window`` samples per
        bucket. Cached between flushes."""
        if self._wait_stats_cache[window] is None:
            src = self._wait_recent if window else self._wait_hist
            out = {}
            for label, hist in src.items():
                a = np.asarray(hist)
                out[label] = {
                    "n": int(a.size),
                    "p50": float(np.percentile(a, 50)),
                    "p99": float(np.percentile(a, 99)),
                    "max": int(a.max()),
                }
            self._wait_stats_cache[window] = out
        return self._wait_stats_cache[window]

    @property
    def stats(self) -> Dict:
        d = dict(self._counters)
        d["generation"] = self.generation
        d["wait_ticks"] = self.wait_stats()
        d["wait_ticks_recent"] = self.wait_stats(window=True)
        d["inflight_age"] = {
            "n": self._inflight_age_n,
            "mean": (self._inflight_age_sum / self._inflight_age_n
                     if self._inflight_age_n else 0.0),
            "max": self._counters["inflight_age_max"],
        }
        d["n_replicas"] = len(self._lanes)
        d["replicas"] = [
            {"replica": lane.rid, "flushes": lane.flushes,
             "served": lane.served, "inflight": len(lane.inflight),
             "inflight_peak": lane.inflight_peak, "stuck": lane.stuck,
             "device": str(lane.pinned) if lane.pinned is not None
             else None}
            for lane in self._lanes]
        return d

    # -- convenience --------------------------------------------------------

    def run(self, reqs: List[CNNRequest], max_ticks: int = 10_000
            ) -> Dict[int, np.ndarray]:
        """Serve a request list to completion; returns rid -> output."""
        self.submit(reqs)
        for _ in range(max_ticks):
            if self.pending() == 0 and \
                    not any(lane.inflight for lane in self._lanes):
                break
            self.tick()
        self.drain()
        return {r.rid: r.out for r in reqs}
