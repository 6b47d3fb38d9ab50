"""The port's CNN batcher over the port's integer models, against the
reference's batcher over the reference's.

Reduced KWS and DarkNet stacks (int8 and their ternary twins) are built on
the JAX side and carried into the port bit for bit with ``interop``
(``test_torch_kws.py`` and ``test_torch_darknet.py`` build them). The
reference serves ``int_serve_fn(..., impl="im2col")``: its fused Pallas conv
does not trace on current jax. The port serves its own ``int_serve_fn`` on
CPU lanes. One seeded mixed-shape arrival trace (the reference benchmark's
``_mixed_arrivals``: Poisson arrivals with same-shape bursts) through the
reference bench's ladders (KWS frames 16 / 24 / 32, DarkNet 12 / 16 / 20)
drives both batchers tick by tick, in sync and dispatch-ahead mode and on
one and two lanes. The decisions must be identical (events with requests
as their ids, wait and finish ticks, generations, normalized payloads,
``stats``); the logits agree within atol 1e-5 (the FP edges sum in another
order, as in the serving tests).

The noise canary's per-flush keys (``fold_in(PRNGKey(noise_seed), trial)``)
are bit-exact with jax's; its perturbed codes are counted against the
reference's flush by flush (normals are not bit-exact across frameworks),
failing above a fraction of 1e-4. The rest of the file holds the port's
batcher to the reference's own unit tests of the policy, on a torch toy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_darknet as dnt
import test_torch_kws as kwt
from repro.core import integer_inference as jii
from repro.core import noise as jnoise
from repro.core.quant import RELU_BOUND
from repro.models import darknet as jdn
from repro.models import frontends as jfront
from repro.models import kws as jkws
from repro.serve import cnn_batching as jcb
from repro.serve import trace as jtrace
from repro_torch import has_cuda, interop
from repro_torch.core import noise as tnoise
from repro_torch.core import prng
from repro_torch.models import darknet as tdn
from repro_torch.models import frontends as tfront
from repro_torch.models import kws as tkws
from repro_torch.serve import cnn_batching as tcb
from repro_torch.serve import faults as tfaults
from repro_torch.serve import shape_ladder as tsl
from repro_torch.serve import trace as ttrace

MAX_FLIP_FRACTION = 1e-4
ATOL_LOGITS = 1e-5   # the reference's own eager-vs-jit logit tolerance
CPU = torch.device("cpu")


def _mixed_arrivals(rng, sample_fn, *, n_ticks, rate, burst_p=0.2,
                    burst=3):
    """Per tick, Poisson(rate) requests; some arrivals burst into ``burst``
    same-shape copies (the reference benchmark's trace)."""
    arrivals = []
    for _ in range(n_ticks):
        batch = []
        for _ in range(int(rng.poisson(rate))):
            x = sample_fn(rng)
            batch.append(x)
            if rng.random() < burst_p:
                batch.extend(np.array(x) for _ in range(burst - 1))
        arrivals.append(batch)
    return arrivals


def _kws_sample(rng):
    t = int(rng.integers(10, 37))  # rf is 9; rungs are 16/24/32
    return rng.standard_normal((t, 8)).astype(np.float32)


def _dn_sample(rng):
    h, w = (int(v) for v in rng.integers(8, 23, size=2))
    return rng.standard_normal((h, w, 3)).astype(np.float32)


# model: (the test module that builds its stacks, reference module, port
#         module, ladder rungs, request sampler, trace ticks, arrival rate)
MODELS = {
    "kws": (kwt, jkws, tkws, (16, 24, 32), _kws_sample, 5, 7.0),
    "darknet": (dnt, jdn, tdn, (12, 16, 20), _dn_sample, 4, 6.0),
}


@functools.lru_cache(maxsize=None)
def _stacks(model, fmt):
    mod = MODELS[model][0]
    if fmt == "int8":
        return mod._reference("reduced")[2], mod._carried("reduced")
    return mod._ternary("reduced")


@functools.lru_cache(maxsize=None)
def _ref_step(model, fmt):
    """One jitted reference step per stack, shared by every batcher."""
    mod, jmod = MODELS[model][:2]
    ip = _stacks(model, fmt)[0]
    return jax.jit(jmod.int_serve_fn(ip, mod.JQCFG, mod.CFGS["reduced"][0],
                                     impl="im2col"))


def _ladders(model):
    rungs = MODELS[model][3]
    mod = MODELS[model][0]
    jcfg, tcfg = mod.CFGS["reduced"][:2]
    build = "kws_serving_ladder" if model == "kws" \
        else "darknet_serving_ladder"
    return (getattr(jfront, build)(jcfg, rungs),
            getattr(tfront, build)(tcfg, rungs))


def _events(log):
    """on_event -> a JSON-stable record, requests as their ids."""
    def on_event(etype, fields):
        fields = {k: ([r.rid for r in v] if k == "reqs" else v)
                  for k, v in fields.items()}
        log.append({"e": etype, **ttrace.jsonable(fields)})
    return on_event


def _batchers(model, fmt, **kw):
    mod, jmod, tmod = MODELS[model][:3]
    ip, st = _stacks(model, fmt)
    jl, tl = _ladders(model)
    jlog, tlog = [], []
    step = _ref_step(model, fmt)
    jb = jcb.CNNBatcher(step, step_fn=step, ladder=jl,
                        on_event=_events(jlog), **kw)
    tb = tcb.CNNBatcher(tmod.int_serve_fn(st, mod.QCFG,
                                          mod.CFGS["reduced"][1]),
                        ladder=tl, on_event=_events(tlog), **kw)
    return (jb, jlog), (tb, tlog)


def _replay(sides, arrivals):
    """Both batchers through the trace, tick by tick, no drain (as the
    reference benchmark replays it); returns each side's requests."""
    reqs = [[] for _ in sides]
    for batch in arrivals:
        for (b, _), rs, req in zip(sides, reqs, (jcb.CNNRequest,
                                                 tcb.CNNRequest)):
            new = [req(rid=len(rs) + i, x=x) for i, x in enumerate(batch)]
            b.submit(new)
            rs.extend(new)
        assert sides[0][0].tick() == sides[1][0].tick()
    for _ in range(200):
        if not sides[0][0].outstanding():
            break
        assert sides[0][0].tick() == sides[1][0].tick()
    assert sides[0][0].outstanding() == sides[1][0].outstanding() == 0
    return reqs


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("fmt", ["int8", "ternary"])
@pytest.mark.parametrize("mode,lanes", [("sync", 1), ("ahead", 1),
                                        ("ahead", 2)])
def test_mixed_trace_matches_reference(model, fmt, mode, lanes):
    sample, n_ticks, rate = MODELS[model][4:]
    arrivals = _mixed_arrivals(np.random.default_rng(0), sample,
                               n_ticks=n_ticks, rate=rate)
    ref, port = _batchers(model, fmt, max_batch=4, max_wait_ticks=2,
                          max_inflight=4, dispatch_ahead=mode == "ahead",
                          n_replicas=lanes)
    jreqs, treqs = _replay((ref, port), arrivals)
    assert ref[1] == port[1]
    assert port[0].stats == ref[0].stats
    assert port[0].n_signatures == ref[0].n_signatures
    assert port[0].stats["ladder_normalized"] > 0
    for a, b in zip(jreqs, treqs):
        assert (a.wait_ticks, a.finish_tick, a.generation) == \
            (b.wait_ticks, b.finish_tick, b.generation)
        assert ttrace.digest(b.x_served) == jtrace.digest(a.x_served)
        want = np.asarray(a.out)
        assert b.out.shape == want.shape and b.out.dtype == want.dtype
        np.testing.assert_allclose(b.out, want, rtol=0, atol=ATOL_LOGITS)
    assert port[0].step_stats["eager_flushes"] == port[0].stats["flushes"]


@pytest.mark.parametrize("seed", [0, 5, 2 ** 31 + 3, -1])
def test_canary_keys_bit_exact(seed):
    """fold_in(PRNGKey(seed), trial), the canary's key of flush ``trial``,
    equals jax.random.fold_in(jax.random.key(seed), trial)."""
    for trial in (0, 1, 2, 7, 1000):
        want = np.asarray(jax.random.key_data(
            jax.random.fold_in(jax.random.key(seed), trial)))
        got = prng.fold_in(prng.PRNGKey(seed), trial)
        assert got.tolist() == want.astype(np.int64).tolist()


@pytest.mark.parametrize("fmt", ["int8", "ternary"])
def test_noise_canary_matches_reference(fmt):
    """Table 7's noisiest condition through both batchers (sync, so flush
    k resolves k-th): one noise trial per flush; flush by flush, the
    port's noisy integer core equals the reference's given the same entry
    codes and key, codes counted; the logits agree."""
    cond = jnoise.TABLE7_CONDITIONS[-1]
    ip, st = _stacks("kws", fmt)
    jcfg, tcfg = kwt.CFGS["reduced"][:2]
    xs = np.random.default_rng(12).standard_normal(
        (6, jcfg.seq_len, jcfg.n_mfcc)).astype(np.float32)
    jlog, tlog = [], []
    jb = jcb.CNNBatcher(jkws.int_serve_fn(ip, kwt.JQCFG, jcfg,
                                          impl="im2col"),
                        max_batch=4, max_wait_ticks=0, noise_config=cond,
                        noise_seed=5, on_event=_events(jlog))
    tb = tcb.CNNBatcher(tkws.int_serve_fn(st, kwt.QCFG, tcfg), max_batch=4,
                        max_wait_ticks=0, noise_seed=5,
                        noise_config=tnoise.NoiseConfig(
                            cond.sigma_w, cond.sigma_a, cond.sigma_mac),
                        on_event=_events(tlog))
    jout = jb.run([jcb.CNNRequest(rid=i, x=xs[i]) for i in range(6)])
    tout = tb.run([tcb.CNNRequest(rid=i, x=xs[i]) for i in range(6)])
    assert jlog == tlog
    assert tb.stats["noise_trials"] == jb.stats["noise_trials"] == 2
    assert tb.step_stats["eager_flushes"] == 2
    flips = codes = 0
    resolves = [e for e in tlog if e["e"] == "resolve"]
    for trial, e in enumerate(resolves):
        x = np.zeros((tcb.batch_bucket(len(e["reqs"]), 4),)
                     + xs.shape[1:], np.float32)
        x[:len(e["reqs"])] = xs[e["reqs"]]
        c = jii.entry_codes(kwt._ref_h(ip, x), ip["entry"], kwt.JQCFG,
                            b_in=RELU_BOUND)
        jk = jax.random.fold_in(jax.random.key(5), trial)
        want = np.asarray(jkws.int_core(ip, c, kwt.JQCFG, jcfg,
                                        impl="im2col", noise=cond, rng=jk))
        tk = prng.fold_in(prng.PRNGKey(5), trial)
        assert torch.equal(tk, interop.key_from_numpy(
            np.asarray(jax.random.key_data(jk)), device="cpu"))
        got = tkws.int_core(st, torch.from_numpy(np.array(c)), kwt.QCFG,
                            tcfg, noise=tb.noise_config, rng=tk).numpy()
        flips += int((got != want).sum())
        codes += want.size
    assert flips <= MAX_FLIP_FRACTION * codes, f"{flips} of {codes} differ"
    clean = tcb.CNNBatcher(tkws.int_serve_fn(st, kwt.QCFG, tcfg),
                           max_batch=4, max_wait_ticks=0).run(
        [tcb.CNNRequest(rid=i, x=xs[i]) for i in range(6)])
    assert any(not np.array_equal(clean[i], tout[i]) for i in range(6))
    for i in range(6):
        np.testing.assert_allclose(tout[i], np.asarray(jout[i]), rtol=0,
                                   atol=ATOL_LOGITS)


def test_mesh_refused():
    with pytest.raises(ValueError, match="mesh"):
        tcb.CNNBatcher(_mark_fn, mesh=object())


def test_lanes_go_to_the_card_unless_placed():
    """An apply_fn with no device and no replica_devices serves on CUDA:
    with no card the batcher raises rather than fall back to the CPU."""
    def fn(x):
        return x
    if has_cuda():
        b = tcb.CNNBatcher(fn)
        assert b._lanes[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcb.CNNBatcher(fn)
    b = tcb.CNNBatcher(fn, n_replicas=2, replica_devices=["cpu", "cpu"])
    assert [l["device"] for l in b.stats["replicas"]] == ["cpu", "cpu"]
    assert all(lane.stream is None for lane in b._lanes)


# -- the reference's unit tests of the policy, on a torch toy ---------------


def _mark_fn(x):
    """Batch-position-sensitive toy model: catches pad-row mixups."""
    return x.sum(dim=tuple(range(1, x.ndim))) + 0.5


_mark_fn.device = CPU


def _reqs(shapes, rng):
    return [tcb.CNNRequest(rid=i, x=rng.standard_normal(s).astype(np.float32))
            for i, s in enumerate(shapes)]


def _direct(x):
    return _mark_fn(torch.from_numpy(np.asarray(x))[None]).numpy()[0]


def test_batch_bucket_policy():
    assert [tcb.batch_bucket(n, 8) for n in (1, 2, 3, 5, 8, 11)] == \
        [1, 2, 4, 8, 8, 8]
    assert tcb.batch_bucket(3, 4) == 4
    assert tcb.batch_bucket(7, 1) == 1


def test_outputs_match_direct_apply_and_pad_rows_counted():
    rng = np.random.default_rng(1)
    b = tcb.CNNBatcher(_mark_fn, max_batch=4, max_wait_ticks=0)
    reqs = _reqs([(5, 2)] * 3, rng)  # 3 requests pad to a 4-slot flush
    out = b.run(reqs)
    assert len(out) == 3 and b.stats["padded_rows"] == 1
    assert b.stats["flushes"] == 1 and b.stats["served"] == 3
    for r in reqs:
        assert r.done and np.array_equal(out[r.rid], _direct(r.x))


def test_shape_buckets_isolate_and_bound_signatures():
    rng = np.random.default_rng(2)
    shapes = [(4, 3)] * 9 + [(6, 3)] * 2 + [(4, 5)]
    b = tcb.CNNBatcher(_mark_fn, max_batch=4, max_wait_ticks=0)
    reqs = _reqs(shapes, rng)
    out = b.run(reqs)
    for r in reqs:
        assert np.array_equal(out[r.rid], _direct(r.x))
    # (4,3): flushes of 4,4,1 -> slots {4,1}; (6,3): slots {2}; (4,5): {1}
    assert b.n_signatures == 4 and b.stats["flushes"] == 5


def test_partial_bucket_waits_then_flushes():
    rng = np.random.default_rng(3)
    b = tcb.CNNBatcher(_mark_fn, max_batch=8, max_wait_ticks=2)
    b.submit(_reqs([(3, 3)] * 2, rng))
    assert b.tick() == 0 and b.tick() == 0
    assert b.tick() == 2  # age 3 > max_wait_ticks: partial flush
    assert b.pending() == 0


def test_wait_clock_resets_after_drain():
    rng = np.random.default_rng(5)
    b = tcb.CNNBatcher(_mark_fn, max_batch=8, max_wait_ticks=3)
    b.submit(_reqs([(3, 3)], rng))
    for _ in range(3):
        b.tick()
    b.drain()
    b.submit(_reqs([(3, 3)], rng))
    assert b.tick() == 0  # fresh clock: not flushed prematurely
    assert b.pending() == 1


def test_bucket_state_garbage_collected():
    rng = np.random.default_rng(6)
    b = tcb.CNNBatcher(_mark_fn, max_batch=4, max_wait_ticks=0)
    b.run(_reqs([(n, 2) for n in range(2, 42)], rng))  # 40 distinct shapes
    assert b._queues == {} and b._age == {}
    assert b.stats["served"] == 40
    b.submit(_reqs([(3, 3)], rng))
    b.tick()
    assert b._queues == {} and b._age == {}


def test_sync_tick_flushes_one_bucket_per_quantum():
    rng = np.random.default_rng(7)
    b = tcb.CNNBatcher(_mark_fn, max_batch=2, max_wait_ticks=0)
    b.submit(_reqs([(2, 2)] * 2 + [(3, 3)] * 2 + [(4, 4)] * 2, rng))
    assert b.tick() == 2 and b.stats["flushes"] == 1
    assert b.tick() == 2 and b.tick() == 2
    assert b.pending() == 0


def test_priority_age_beats_fill():
    rng = np.random.default_rng(8)
    b = tcb.CNNBatcher(_mark_fn, max_batch=2, max_wait_ticks=5)
    odd = _reqs([(3, 3)], rng)
    b.submit(odd)
    done_at = None
    for t in range(12):  # hot bucket refills every tick, always full
        b.submit([tcb.CNNRequest(
            rid=100 + t * 2 + i,
            x=rng.standard_normal((2, 2)).astype(np.float32))
            for i in range(2)])
        b.tick()
        if odd[0].done and done_at is None:
            done_at = t
    assert done_at is not None and done_at <= 8, done_at


def test_dispatch_ahead_resolves_next_tick_and_window_backpressure():
    rng = np.random.default_rng(9)
    b = tcb.CNNBatcher(_mark_fn, max_batch=2, max_wait_ticks=0,
                       dispatch_ahead=True, max_inflight=1)
    reqs = _reqs([(2, 2)] * 2 + [(3, 3)] * 2 + [(4, 4)] * 2, rng)
    b.submit(reqs)
    assert b.tick() == 0            # dispatched, parked in flight
    assert b.in_flight == 2 and not reqs[0].done
    assert b.stats["window_waits"] == 1 and b.stats["inflight_peak"] == 1
    assert b.tick() == 2            # resolved one quantum later
    for _ in range(6):
        b.tick()
    assert b.stats["served"] == 6 and b.outstanding() == 0
    for r in reqs:
        assert np.array_equal(r.out, _direct(r.x))


def test_drain_resolves_inflight():
    rng = np.random.default_rng(12)
    b = tcb.CNNBatcher(_mark_fn, max_batch=8, max_wait_ticks=50,
                       dispatch_ahead=True, max_inflight=2)
    reqs = _reqs([(3, 3)] * 5 + [(2, 2)] * 3, rng)
    b.submit(reqs)
    assert b.drain() == 8
    assert all(r.done for r in reqs) and b.in_flight == 0


def test_wait_tick_stats_windowed_not_history_diluted():
    rng = np.random.default_rng(113)
    b = tcb.CNNBatcher(_mark_fn, max_batch=2, max_wait_ticks=4,
                       wait_window=8)
    for _ in range(16):  # healthy era: full buckets, zero wait
        b.submit(_reqs([(3, 3)] * 2, rng))
        b.tick()
    for _ in range(8):   # regression era: singletons age 4 ticks
        b.submit(_reqs([(3, 3)], rng))
        for _ in range(5):
            b.tick()
    label, = b.stats["wait_ticks"].keys()
    life = b.stats["wait_ticks"][label]
    recent = b.stats["wait_ticks_recent"][label]
    assert "(3, 3)" in label and life["n"] == 40 and life["p50"] == 0.0
    assert recent["n"] == 8 and recent["p50"] == recent["max"] == 4
    assert b.wait_stats(window=True) is b.stats["wait_ticks_recent"]


def test_ladder_integration_normalizes_and_counts():
    rng = np.random.default_rng(14)
    lad = tsl.ShapeLadder(tsl.LadderSpec("frames", (6,), 3))
    b = tcb.CNNBatcher(_mark_fn, max_batch=4, max_wait_ticks=0, ladder=lad)
    reqs = _reqs([(4, 3), (6, 3), (9, 3), (5, 7)], rng)  # last: miss
    out = b.run(reqs)
    st = b.stats
    assert st["ladder_hits"] == 3 and st["ladder_misses"] == 1
    assert st["ladder_normalized"] == 2  # (4,3) padded, (9,3) cropped
    assert {k[0] for k in b._signatures} == {((6, 3), "<f4"), ((5, 7), "<f4")}
    for r in reqs:
        assert np.array_equal(out[r.rid], _direct(r.x_served))


def test_stats_expose_fault_and_age_counters():
    plan = tfaults.FaultPlan(seed=9, p_flush_fail=0.5, p_stuck=0.6,
                             max_stuck_ticks=3, max_retries=2,
                             backoff_ticks=1)
    b = tcb.CNNBatcher(_mark_fn, max_batch=2, max_wait_ticks=0,
                       dispatch_ahead=True, max_inflight=2,
                       device=tfaults.FaultyDevice(plan))
    reqs = _reqs([(6, 3)] * 10, np.random.default_rng(3))
    b.submit(reqs)
    for _ in range(60):
        if not b.outstanding():
            break
        b.tick()
    b.drain()
    st = b.stats
    assert st["flush_faults"] > 0 and st["retries"] > 0
    age = st["inflight_age"]
    assert age["n"] > 0 and age["max"] >= 1 and age["mean"] <= age["max"]
    assert st["served"] + st["shed"] == len(reqs)


def test_results_carry_generation_stamp():
    b = tcb.CNNBatcher(_mark_fn, max_batch=4, max_wait_ticks=0)
    rng = np.random.default_rng(4)
    first = _reqs([(6, 3)] * 2, rng)
    b.submit(first)
    b.drain()
    plus = lambda x: _mark_fn(x) + 1.0  # noqa: E731
    b.swap_apply_fn(plus)
    b.swap_apply_fn(plus)
    second = [tcb.CNNRequest(rid=10 + i, x=rng.standard_normal(
        (6, 3)).astype(np.float32)) for i in range(2)]
    b.submit(second)
    b.drain()
    assert b.generation == 2 and b.stats["generation"] == 2
    assert all(r.generation == 0 for r in first)
    assert all(r.generation == 2 for r in second)
    assert np.array_equal(second[0].out, _direct(second[0].x) + 1.0)
    with pytest.raises(ValueError):
        b.swap_apply_fn(plus, replica_apply_fns=[plus, plus])


def test_noise_canary_zero_sigma_is_the_clean_path():
    ip, st = _stacks("kws", "int8")
    tcfg = kwt.CFGS["reduced"][1]
    fn = tkws.int_serve_fn(st, kwt.QCFG, tcfg)
    xs = np.random.default_rng(11).standard_normal(
        (5, tcfg.seq_len, tcfg.n_mfcc)).astype(np.float32)
    out0 = tcb.CNNBatcher(fn, max_batch=4, max_wait_ticks=0).run(
        [tcb.CNNRequest(rid=i, x=xs[i]) for i in range(5)])
    bz = tcb.CNNBatcher(fn, max_batch=4, max_wait_ticks=0,
                        noise_config=tnoise.NoiseConfig(0.0, 0.0, 0.0))
    outz = bz.run([tcb.CNNRequest(rid=i, x=xs[i]) for i in range(5)])
    for i in range(5):
        assert np.array_equal(out0[i], outz[i])
    assert bz.stats["noise_trials"] == 0


def test_noise_canary_replays_and_flush_keys_differ():
    ip, st = _stacks("kws", "int8")
    tcfg = kwt.CFGS["reduced"][1]
    fn = tkws.int_serve_fn(st, kwt.QCFG, tcfg)
    x = np.random.default_rng(13).standard_normal(
        (tcfg.seq_len, tcfg.n_mfcc)).astype(np.float32)

    def canary():
        b = tcb.CNNBatcher(fn, max_batch=1, max_wait_ticks=0, noise_seed=9,
                           noise_config=tnoise.TABLE7_CONDITIONS[-1])
        return b, b.run([tcb.CNNRequest(rid=i, x=x.copy()) for i in range(2)])

    b1, out1 = canary()
    assert b1.stats["noise_trials"] == 2
    assert not np.array_equal(out1[0], out1[1])  # a fresh key per flush
    _, out2 = canary()
    for i in range(2):
        assert np.array_equal(out1[i], out2[i])
