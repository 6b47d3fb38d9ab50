"""Seeded schedules through the port's CNN batcher, against the reference's.

The schedule generator is the reference fuzz sweep's
(``tests/test_serving_fuzz.py``: mixed shapes and dtypes, bursts,
interleaved submit / tick / drain; with faults, also deadline sheds and
hot swaps), written here so that one seeded generator drives several
batchers in lockstep: the reference's ``repro.serve.cnn_batching.CNNBatcher``
over a jitted jax toy step and the port's over the same toy in torch, on
CPU lanes. Every tick and drain must complete as many requests on both
sides, and at the end the two must agree exactly on

  * the ``on_event`` streams, recorded into each package's ``Trace`` (every
    output, payload and normalized payload as its ``digest``);
  * every request's ``out``, ``wait_ticks``, ``finish_tick``,
    ``generation``, ``error`` and normalized payload;
  * ``stats`` and ``n_signatures``.

The toy rounds inputs onto an integer lattice and reduces in int32, so
every comparison is exact equality. The port-only sweeps below hold the
port's batcher to the reference sweep's own invariants (exactly once,
bit-exact against the unbatched toy, lane-count invariance, the signature
bound, atomic intake, retry budget and backoff) over its full seed counts.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import cnn_batching as jcb
from repro.serve import faults as jfaults
from repro.serve import shape_ladder as jsl
from repro.serve import trace as jtrace
from repro_torch.serve import cnn_batching as tcb
from repro_torch.serve import faults as tfaults
from repro_torch.serve import shape_ladder as tsl
from repro_torch.serve import trace as ttrace

CPU = torch.device("cpu")
_SHAPES = [(5, 3), (4, 4), (7, 2), (3, 3, 2), (6,)]
# rank-2 feat-3 frames and rank-3 channel-2 planes are rungs; feat-4
# payloads are deliberate ladder misses (served raw)
_LADDER_SPECS = [("frames", (5, 8), 3), ("image", (6,), 2)]
_LADDER_SHAPES = [(3, 3), (5, 3), (7, 3), (9, 3),      # frames hits
                  (4, 5, 2), (7, 7, 2), (8, 3, 2),     # image hits
                  (4, 4)]                              # feat-4 miss


def _jgen(g):
    """The reference family: generation g is visible in every output."""
    def fn(x, noise=None, rng=None):
        xi = jnp.round(x.astype(jnp.float32) * 8.0).astype(jnp.int32)
        axes = tuple(range(1, x.ndim))
        return jnp.sum(xi * xi, axis=axes) * (3 + g) \
            + jnp.max(xi, axis=axes) - g
    return fn


def _tgen(g):
    """The same family in torch, on the CPU."""
    def fn(x, noise=None, rng=None):
        xi = torch.round(x.to(torch.float32) * 8.0).to(torch.int32)
        axes = tuple(range(1, x.ndim))
        return (xi * xi).sum(dim=axes, dtype=torch.int32) * (3 + g) \
            + xi.amax(dim=axes) - g
    fn.device = CPU
    return fn


_JSTEPS = {}  # one jit per generation, shared by every reference batcher


def _jstep(g):
    if g not in _JSTEPS:
        _JSTEPS[g] = jax.jit(_jgen(g))
    return _JSTEPS[g]


class _Side:
    """One package's batcher, requests and event trace for one schedule."""

    def __init__(self, pkg, kw, plan, ladder):
        self.pkg = pkg
        self.trace = (jtrace if pkg == "ref" else ttrace).Trace()
        cb, sl, fl = (jcb, jsl, jfaults) if pkg == "ref" \
            else (tcb, tsl, tfaults)
        self.request = cb.CNNRequest
        extra = dict(on_event=lambda e, f: self.trace.emit(e, **f))
        if ladder:
            extra["ladder"] = sl.ShapeLadder(
                *[sl.LadderSpec(*s) for s in ladder])
        if plan is not None:
            extra["device"] = fl.FaultyDevice(fl.FaultPlan(**plan))
        if pkg == "ref":
            self.b = cb.CNNBatcher(_jgen(0), step_fn=_jstep(0), **kw, **extra)
        else:
            self.b = cb.CNNBatcher(_tgen(0), **kw, **extra)
        self.reqs = []

    def swap(self):
        g = self.b.generation + 1
        if self.pkg == "ref":
            self.b.swap_apply_fn(_jgen(g), step_fn=_jstep(g))
        else:
            self.b.swap_apply_fn(_tgen(g))


def _payload(rng, shapes):
    shape = shapes[int(rng.integers(len(shapes)))]
    if rng.random() < 0.4:
        return rng.integers(-8, 8, size=shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


def _all(sides, fn):
    """fn on every side; each must return the same value."""
    out = [fn(s) for s in sides]
    assert all(o == out[0] for o in out), out
    return out[0]


def _submit(sides, rng, n, shapes):
    xs = [_payload(rng, shapes) for _ in range(n)]
    for s in sides:
        rs = [s.request(rid=len(s.reqs) + i, x=x.copy())
              for i, x in enumerate(xs)]
        s.b.submit(rs)
        s.reqs.extend(rs)


def _drive(pkgs, seed, dispatch_ahead, *, ladder=None, shapes=_SHAPES,
           n_ops=14, n_replicas=1):
    """The reference sweep's schedule (``_run_schedule``), on every side."""
    rng = np.random.default_rng(seed)
    kw = dict(max_batch=int(rng.choice([2, 4, 8])),
              max_wait_ticks=int(rng.integers(0, 4)),
              dispatch_ahead=dispatch_ahead,
              max_inflight=int(rng.integers(1, 5)), n_replicas=n_replicas)
    sides = [_Side(p, kw, None, ladder) for p in pkgs]
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.55:
            _submit(sides, rng, int(rng.integers(1, 5)), shapes)
        elif op < 0.9:
            _all(sides, lambda s: s.b.tick())
        else:
            _all(sides, lambda s: s.b.drain())
    for _ in range(500):
        if not _all(sides, lambda s: s.b.outstanding()):
            break
        _all(sides, lambda s: s.b.tick())
    assert not _all(sides, lambda s: s.b.outstanding()), \
        f"seed {seed}: requests stuck"
    _all(sides, lambda s: s.b.drain())  # idempotent on empty state
    return sides


def _drive_faults(pkgs, seed, dispatch_ahead, *, n_ops=18):
    """The reference sweep's fault schedule (``_run_fault_schedule``)."""
    rng = np.random.default_rng(seed)
    plan = dict(seed=seed, p_flush_fail=float(rng.choice([0.2, 0.4])),
                p_stuck=float(rng.choice([0.0, 0.3])), max_stuck_ticks=2,
                p_canary_corrupt=0.0, max_retries=int(rng.integers(1, 4)),
                backoff_ticks=1)
    kw = dict(max_batch=int(rng.choice([2, 4])),
              max_wait_ticks=int(rng.integers(0, 3)),
              dispatch_ahead=dispatch_ahead,
              max_inflight=int(rng.integers(1, 4)))
    sides = [_Side(p, kw, plan, None) for p in pkgs]
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.45:
            _submit(sides, rng, int(rng.integers(1, 4)), _SHAPES)
        elif op < 0.75:
            _all(sides, lambda s: s.b.tick())
        elif op < 0.85:
            age = int(rng.integers(2, 6))
            _all(sides, lambda s: [r.rid for r in s.b.shed_expired(age)])
        elif op < 0.95:
            for s in sides:
                s.swap()
        else:
            _all(sides, lambda s: s.b.drain())
    for _ in range(800):
        if not _all(sides, lambda s: s.b.outstanding()):
            break
        _all(sides, lambda s: s.b.tick())
        if rng.random() < 0.1:  # keep shedding stale work while settling
            _all(sides, lambda s: [r.rid for r in s.b.shed_expired(4)])
    _all(sides, lambda s: s.b.drain())
    assert not _all(sides, lambda s: s.b.outstanding()), \
        f"seed {seed}: requests stuck"
    return sides


def _assert_same(ref, port, seed):
    rep = ttrace.compare(ref.trace, port.trace)
    assert rep.bit_exact, (seed, rep.summary())
    assert len(ref.reqs) == len(port.reqs) and ref.reqs, seed
    for a, b in zip(ref.reqs, port.reqs):
        assert (a.done, a.wait_ticks, a.finish_tick, a.generation,
                a.submit_tick, a.error) == (b.done, b.wait_ticks,
                                            b.finish_tick, b.generation,
                                            b.submit_tick, b.error), seed
        assert ttrace.digest(b.x_served) == jtrace.digest(a.x_served)
        if a.out is None:
            assert b.out is None, (seed, a.rid)
        else:
            assert type(b.out) is type(a.out), (seed, a.rid)
            assert ttrace.digest(b.out) == jtrace.digest(a.out), (seed, a.rid)
    assert port.b.stats == ref.b.stats, seed
    assert port.b.n_signatures == ref.b.n_signatures, seed


# -- the port against the reference, seed for seed ---------------------------


@pytest.mark.parametrize("dispatch_ahead", [False, True])
def test_schedules_match_reference(dispatch_ahead):
    """40 seeds per flush mode, 1-3 replica lanes."""
    for seed in range(40):
        ref, port = _drive(("ref", "port"), seed, dispatch_ahead,
                           n_replicas=1 + seed % 3)
        _assert_same(ref, port, seed)


@pytest.mark.parametrize("dispatch_ahead", [False, True])
def test_ladder_schedules_match_reference(dispatch_ahead):
    """40 laddered seeds per flush mode (hits, crops, pads and misses),
    1-3 replica lanes."""
    for seed in range(1000, 1040):
        ref, port = _drive(("ref", "port"), seed, dispatch_ahead,
                           ladder=_LADDER_SPECS, shapes=_LADDER_SHAPES,
                           n_replicas=1 + seed % 3)
        _assert_same(ref, port, seed)
        assert port.b.stats["ladder_hits"] > 0


@pytest.mark.parametrize("dispatch_ahead", [False, True])
def test_fault_schedules_match_reference(dispatch_ahead):
    """40 seeds per flush mode under a FaultPlan (failed and stuck
    flushes, retries, sheds), deadline sheds and hot swaps."""
    swaps = faults = 0
    for seed in range(2000, 2040):
        ref, port = _drive_faults(("ref", "port"), seed, dispatch_ahead)
        _assert_same(ref, port, seed)
        swaps += port.b.generation
        faults += port.b.stats["flush_faults"]
    assert swaps > 0 and faults > 0


# -- the port's own invariants ------------------------------------------------


def _check_schedule(side, seed):
    b, reqs = side.b, side.reqs
    assert len({r.rid for r in reqs}) == len(reqs)
    assert b.stats["served"] == len(reqs), seed
    toy = _tgen(0)
    for r in reqs:
        assert r.done, (seed, r.rid)
        want = toy(torch.from_numpy(np.asarray(r.x_served))[None]).numpy()[0]
        assert np.array_equal(np.asarray(r.out), want), (seed, r.rid)
        assert r.wait_ticks >= 0
    assert b._queues == {} and b._age == {}, seed
    assert not b._inflight
    assert b.step_stats["eager_flushes"] == b.stats["flushes"]
    assert b.step_stats["graph_flushes"] == b.n_graphs == 0


@pytest.mark.parametrize("dispatch_ahead", [False, True])
def test_fuzz_schedules_bit_exact(dispatch_ahead):
    """110 seeded schedules per flush mode."""
    for seed in range(110):
        side, = _drive(("port",), seed, dispatch_ahead)
        _check_schedule(side, seed)


@pytest.mark.parametrize("dispatch_ahead", [False, True])
def test_fuzz_schedules_with_ladder(dispatch_ahead):
    """Parity is against the normalized payload; misses serve raw; the
    signature count respects the ladder bound plus one bucket family per
    missed shape."""
    slots = {2: 2, 4: 3, 8: 4}
    ladder = tsl.ShapeLadder(*[tsl.LadderSpec(*s) for s in _LADDER_SPECS])
    for seed in range(1000, 1040):
        side, = _drive(("port",), seed, dispatch_ahead,
                       ladder=_LADDER_SPECS, shapes=_LADDER_SHAPES)
        _check_schedule(side, seed)
        b, reqs, st = side.b, side.reqs, side.b.stats
        assert st["ladder_hits"] + st["ladder_misses"] == len(reqs)
        rungs = set(ladder.shapes)
        for r in reqs:
            if ladder.spec_for(np.asarray(r.x).shape) is not None:
                assert tuple(r.x_served.shape) in rungs, (seed, r.rid)
            else:
                assert r.x_served.shape == np.asarray(r.x).shape
        miss_families = len({(tuple(r.x_served.shape), r.x_served.dtype.str)
                             for r in reqs
                             if tuple(r.x_served.shape) not in rungs})
        bound = (len(ladder.shapes) * 2 + miss_families) \
            * slots[b.max_batch]  # x2: float32 and int8 code payloads
        assert b.n_signatures <= bound, (seed, b.n_signatures, bound)


def test_modes_agree_bit_exact():
    """Dispatch-ahead changes when results land, never what they are."""
    for seed in (7, 21, 63):
        sync, = _drive(("port",), seed, False)
        ahead, = _drive(("port",), seed, True)
        assert len(sync.reqs) == len(ahead.reqs)
        for a, c in zip(sync.reqs, ahead.reqs):
            assert np.array_equal(np.asarray(a.out), np.asarray(c.out))


@pytest.mark.parametrize("dispatch_ahead", [False, True])
def test_fuzz_multi_replica_bit_exact(dispatch_ahead):
    """1, 2 and 4 lanes: exactly once, bit-exact, and byte-identical to
    the one-lane run of the same schedule."""
    for seed in range(3000, 3025):
        outs_by_n = {}
        for n in (1, 2, 4):
            side, = _drive(("port",), seed, dispatch_ahead, n_replicas=n)
            _check_schedule(side, (seed, n))
            st = side.b.stats
            assert st["n_replicas"] == n and len(st["replicas"]) == n
            assert sum(l["flushes"] for l in st["replicas"]) \
                == st["flushes"], (seed, n)
            assert sum(l["served"] for l in st["replicas"]) \
                == st["served"], (seed, n)
            assert all(l["inflight"] == 0 for l in st["replicas"])
            outs_by_n[n] = [np.asarray(r.out) for r in side.reqs]
        for n in (2, 4):
            assert len(outs_by_n[n]) == len(outs_by_n[1])
            for a, c in zip(outs_by_n[1], outs_by_n[n]):
                assert np.array_equal(a, c), (seed, n)


def _batcher(**kw):
    return tcb.CNNBatcher(_tgen(0), **kw)


def test_double_submit_rejected():
    b = _batcher(max_batch=2)
    r = tcb.CNNRequest(rid=0, x=np.ones((5, 3), np.float32))
    b.submit([r])
    with pytest.raises(ValueError):
        b.submit([r])
    b.drain()
    with pytest.raises(ValueError):  # done requests can't be resubmitted
        b.submit([r])
    fresh = tcb.CNNRequest(rid=1, x=np.ones((5, 3), np.float32))
    with pytest.raises(ValueError):  # intake is all-or-nothing
        b.submit([fresh, r])
    assert b.pending() == 0 and fresh.x_served is None
    b.submit([fresh])
    assert b.pending() == 1
    b.drain()


def test_submit_rejects_duplicate_in_one_call():
    b = _batcher(max_batch=2)
    r = tcb.CNNRequest(rid=0, x=np.ones((5, 3), np.float32))
    r2 = tcb.CNNRequest(rid=1, x=np.ones((5, 3), np.float32))
    with pytest.raises(ValueError):
        b.submit([r, r2, r])
    assert b.pending() == 0 and r.x_served is None and r2.x_served is None
    b.submit([r, r2])
    assert b.drain() == 2


def test_submit_atomic_on_malformed_payload():
    b = _batcher(max_batch=2)
    good = tcb.CNNRequest(rid=0, x=np.ones((5, 3), np.float32))
    bad = tcb.CNNRequest(rid=1, x=[[1.0, 2.0], [3.0]])  # ragged
    with pytest.raises(ValueError):
        b.submit([good, bad])
    assert b.pending() == 0 and good.x_served is None
    b.submit([good])
    assert b.pending() == 1


@pytest.mark.parametrize("dispatch_ahead", [False, True])
def test_fuzz_faults_and_swaps_exactly_once(dispatch_ahead):
    """Every request ends served (bit-exact under the generation that
    flushed it) or shed with a structured error."""
    for seed in range(2000, 2030):
        side, = _drive_faults(("port",), seed, dispatch_ahead)
        b, served, shed = side.b, 0, 0
        for r in side.reqs:
            assert r.done, (seed, r.rid)
            if r.error is not None:
                shed += 1
                assert r.out is None and r.error["rid"] == r.rid
                assert r.error["code"] in ("deadline", "flush-fault")
            else:
                served += 1
                want = _tgen(r.generation)(torch.from_numpy(
                    np.asarray(r.x_served))[None]).numpy()[0]
                assert np.array_equal(np.asarray(r.out), want), (seed, r.rid)
                assert r.finish_tick >= r.submit_tick >= 0
        st = b.stats
        assert served + shed == len(side.reqs), seed
        assert st["served"] == served and st["shed"] == shed, seed
        assert st["retries"] <= st["flush_faults"], seed
        assert b._queues == {} and not b._inflight, seed


def test_fault_shed_after_retry_budget():
    plan = tfaults.FaultPlan(seed=0, p_flush_fail=1.0, max_retries=2,
                             backoff_ticks=1)
    b = _batcher(max_batch=2, max_wait_ticks=0,
                 device=tfaults.FaultyDevice(plan))
    rs = [tcb.CNNRequest(rid=i, x=np.ones((5, 3), np.float32))
          for i in range(2)]
    b.submit(rs)
    for _ in range(20):
        b.tick()
        if all(r.done for r in rs):
            break
    assert all(r.done and r.error["code"] == "flush-fault" for r in rs)
    assert all(r.out is None for r in rs)
    assert b.stats["shed"] == 2 and b.stats["flush_faults"] >= 3
    assert b.drain() == 0


def test_backoff_delays_retry():
    class OneShot:
        """Fails the first flush attempt only."""
        max_retries, backoff_ticks = 3, 2

        def __init__(self):
            self.dev = tfaults.FaultyDevice(
                tfaults.FaultPlan(seed=1, p_flush_fail=1.0))
            self.calls = 0

        def flush_fate(self, *, tick=-1):
            self.calls += 1
            if self.calls == 1:
                return self.dev.flush_fate(tick=tick)
            return tfaults.FlushFate(False, 0, -1)

    dev = OneShot()
    b = _batcher(max_batch=2, max_wait_ticks=0, device=dev)
    r = tcb.CNNRequest(rid=0, x=np.ones((5, 3), np.float32))
    b.submit([r])
    b.tick()                      # faults; backoff until tick + 2
    assert not r.done and b.stats["retries"] == 1
    b.tick()                      # still backing off: no flush attempt
    assert dev.calls == 1 and not r.done
    b.tick()                      # backoff expired: retries and serves
    assert r.done and r.error is None


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_fault_draws_match_reference(seed):
    """Every fate of a long draw sequence, in value and in order."""
    kw = dict(seed=seed, p_flush_fail=0.3, p_stuck=0.5, max_stuck_ticks=3,
              p_canary_corrupt=0.4)
    jd = jfaults.FaultyDevice(jfaults.FaultPlan(**kw))
    td = tfaults.FaultyDevice(tfaults.FaultPlan(**kw))
    for i in range(200):
        if i % 3:
            assert dataclasses.astuple(td.flush_fate(tick=i)) == \
                dataclasses.astuple(jd.flush_fate(tick=i))
        else:
            assert td.canary_fate() == jd.canary_fate()
    assert td.draws == jd.draws
    with pytest.raises(ValueError):
        tfaults.FaultPlan(p_stuck=1.5)
