"""The port's fleet on real integer stacks, in lockstep with the reference's.

Reduced KWS (on 2 replica lanes) and reduced DarkNet: their float params are
``test_torch_planlint.standin``'s (the port's seeded init -> to_fq, a
uniform s_out of 0.1 tied along the chain), converted by the reference and
carried into the port with ``interop``. The finetune set and the KWS canary
probe are a synthetic MFCC set (``data.synthetic``, noise 2.0, as the
reference's fleet demo uses), handed to both sides as the same numpy
arrays; the DarkNet probe is 4 seeded normal images. One schedule -- the
demo's, shortened: 2 KWS requests a tick, 1 DarkNet request every 3rd tick,
Table 7's noisiest condition on KWS after PRE_TICKS, 14 ticks, an active
``FaultPlan`` -- drives both runtimes; the KWS canary breaches and
``QATFinetuneJob`` retrains (4 steps at batch 8, 2 noise draws, 2 steps a
tick) before the swap. Held, with the tolerances stated:

* every event's type, tick, model, rids, generation, shed code, fault draw,
  canary agreement and digest of stack and probe at registration: equal,
  event for event;
* outputs served by the converted stacks (generation 0): KWS within atol
  1e-5 and DarkNet within 1e-5 of the largest |logit| (the serving tests'
  tolerances: the FP edges sum in another order);
* retrain losses within 1e-3 relative, and outputs served by the retrained
  stack within 1e-3 of the largest |logit|: the reference's QAT step is
  jitted and the port's eager, so the float params part by a few ulps a
  step (C-ref-3), and the noisy loss's perturbed codes follow normals that
  differ from jax's by a few ulps in ~5% of draws (C4). Measured on this
  host: losses 1.9e-6 and 4.1e-4 relative, retrained outputs 2.8e-5 of
  logits near 0.3;
* the swapped stack: weight codes equal the reference's except at most
  ``MAX_CODE_DIFF`` (measured: 0), folded scalars within 1e-4 relative
  (measured: <= 9.7e-6), and its digest equals the reference's exactly
  when no code and no scalar differs (measured: they differ, by the
  scalars);
* the generation count equals the reference's (C-ref-7: the reference's
  dry demo flaps to generation 3 on this host);
* ``trace.replay`` of the port's incident is bit-exact;
* ``cuda``-marked: a two-lane fleet on one card, whose swap installs lane
  by lane (skips without a GPU).
"""
import functools

import numpy as np
import pytest
import torch

import test_torch_planlint as plt
from repro_torch import has_cuda
from repro_torch.core import integer_inference as tii
from repro_torch.core import prng
from repro_torch.core.noise import TABLE7_CONDITIONS
from repro_torch.data import synthetic as tsyn
from repro_torch.models import darknet as tdn
from repro_torch.models import kws as tkws
from repro_torch.serve import faults as tfaults
from repro_torch.serve import fleet as tfleet
from repro_torch.serve import trace as tr

try:
    import jax
    import jax.numpy as jnp
    from repro.core import integer_inference as jii
    from repro.serve import faults as jfaults
    from repro.serve import fleet as jfleet
    from repro.serve import trace as jtrace
except ImportError:  # the card's machine has no jax: -m cuda runs alone
    jax = None

pytestmark = pytest.mark.fleet

QCFG = plt.QCFG
JQCFG = plt.JQCFG if jax is not None else None
KWS_CFGS = plt.MODELS["kws"][2:]
DN_CFGS = plt.MODELS["darknet"][2:]
DN_SIDE = 16
PLAN = dict(seed=11, p_flush_fail=0.15, p_stuck=0.2, max_stuck_ticks=2,
            p_canary_corrupt=0.08, max_retries=3, backoff_ticks=1)
KWS_SLO = dict(deadline_ticks=8, max_agreement_drop=0.25, canary_every=1,
               canary_window=3, baseline_obs=2, retrain_steps_per_tick=2)
DN_SLO = dict(deadline_ticks=8, max_agreement_drop=0.5, canary_every=2,
              canary_window=3, baseline_obs=2)
PRE_TICKS, POST_TICKS = 4, 10
FT = dict(steps=4, lr=0.01, batch=8, draws=2, seed=7)
N_TRAIN = 32
LANES = 2
BATCHER = dict(max_wait_ticks=1, dispatch_ahead=True, max_inflight=2)
KWS_ATOL = 1e-5          # generation 0: the KWS serving tests' tolerance
DN_RTOL = 1e-5           # x max|logit|: the DarkNet serving tests'
RETRAINED_RTOL = 1e-3    # x max|logit|: outputs of the retrained stack
LOSS_RTOL = 1e-3         # retrain losses
SCALAR_RTOL = 1e-4       # the swapped stack's folded scalars
MAX_CODE_DIFF = 4        # its weight codes that may differ


@functools.lru_cache(maxsize=None)
def _inputs():
    """Both sides' stacks and KWS float params, the finetune set and the
    canary probes."""
    kip, kst, kp, ks = plt.stacks("kws")
    dip, dst, _, _ = plt.stacks("darknet")
    jk = KWS_CFGS[0]
    x, y = tsyn.make_mfcc_dataset(
        prng.PRNGKey(5, device="cpu"), n=N_TRAIN + 16, seq_len=jk.seq_len,
        n_mfcc=jk.n_mfcc, num_classes=jk.num_classes, noise=2.0)
    data = (x[:N_TRAIN].numpy(), y[:N_TRAIN].numpy())
    probe = x[N_TRAIN:].numpy()
    dn_probe = np.random.default_rng(0).standard_normal(
        (4, DN_SIDE, DN_SIDE, DN_CFGS[0].in_channels)).astype(np.float32)
    np_p, np_s = plt.standin("kws")
    jp, js = jax.tree_util.tree_map(jnp.asarray, (np_p, np_s))
    return dict(
        ref=(jp, js, kip, tuple(jnp.asarray(a) for a in data), dip),
        port=(kp, ks, kst, tuple(torch.from_numpy(a) for a in data), dst),
        probe=probe, dn_probe=dn_probe)


def _build(side, fresh, synced_sink=None):
    """Rebuild the two-model registry on one side (the reference's or the
    port's), emitting into ``fresh``: the fleet demo's ``build_fleet`` on
    reduced stacks, KWS on two replica lanes."""
    inp = _inputs()
    fresh.emit("config", note="real")
    if side == "ref":
        mod, faults, kmod, dmod, qcfg, cfgs = (
            jfleet, jfaults, plt.jkws, plt.jdn, JQCFG, (0, 0))
    else:
        mod, faults, kmod, dmod, qcfg, cfgs = (
            tfleet, tfaults, tkws, tdn, QCFG, (1, 1))
    kp, ks, kip, data, dip = inp[side]
    kcfg, dcfg = KWS_CFGS[cfgs[0]], DN_CFGS[cfgs[1]]

    def factory(stack, condition):
        return mod.QATFinetuneJob(kmod, kp, ks, kcfg, qcfg, condition,
                                  data=data, on_result=synced_sink, **FT)

    fl = mod.FleetRuntime(fault_plan=faults.FaultPlan(**PLAN), trace=fresh)
    fl.register("kws", kip, lambda s: kmod.int_serve_fn(s, qcfg, kcfg),
                slo=mod.ModelSLO(**KWS_SLO), probe=inp["probe"],
                canary_seed=31, finetune_factory=factory,
                batcher_kw=dict(BATCHER, max_batch=8), n_replicas=LANES)
    fl.register("darknet", dip, lambda s: dmod.int_serve_fn(s, qcfg, dcfg),
                slo=mod.ModelSLO(**DN_SLO), probe=inp["dn_probe"],
                canary_seed=47, batcher_kw=dict(BATCHER, max_batch=4))
    fl.shapes = {"kws": (kcfg.seq_len, kcfg.n_mfcc),
                 "darknet": (DN_SIDE, DN_SIDE, dcfg.in_channels)}
    return fl


def _drive(fl):
    rid = {"kws": 0, "darknet": 10_000}
    cond = TABLE7_CONDITIONS[-1]

    def arrive(model, n):
        fl.submit(model, [tfleet.RequestSpec(rid=rid[model] + i, seed=3,
                                             shape=fl.shapes[model])
                          for i in range(n)])
        rid[model] += n
    for t in range(PRE_TICKS + POST_TICKS):
        if t == PRE_TICKS:
            fl.set_condition("kws", (cond.sigma_w, cond.sigma_a,
                                     cond.sigma_mac))
        arrive("kws", 2)
        if t % 3 == 0:
            arrive("darknet", 1)
        fl.tick()
    fl.drain()


@functools.lru_cache(maxsize=None)
def _incident():
    """(reference fleet, its trace, port fleet, its trace, the synced
    params the port's jobs handed over)."""
    jt, t, synced = jtrace.Trace(), tr.Trace(), []
    jfl = _build("ref", jt)
    _drive(jfl)
    fl = _build("port", t, synced.append)
    _drive(fl)
    return jfl, jt, fl, t, synced


# fields compared numerically below, not exactly: output digests, retrain
# losses, the swapped stack's digest
_FLOAT_FIELDS = ("outs", "loss", "stack")


def _control(evt):
    return {k: v for k, v in evt.items()
            if k not in _FLOAT_FIELDS or evt["e"] == "register"}


def test_incident_reaches_breach_retrain_and_swap():
    _, jt, fl, t, _ = _incident()
    for trace in (jt, t):
        breach, swaps = trace.of_type("breach"), trace.of_type("swap")
        assert breach and breach[0]["model"] == "kws"
        assert trace.of_type("retrain") and trace.of_type("fault")
        assert swaps and swaps[0]["tick"] > breach[0]["tick"]
        assert {e["replica"] for e in trace.of_type("swap-replica")} == \
            {0, 1}
    for name in fl.models:
        a = fl.audit(name)
        assert a["exactly_once"] and a["within_slo"] and a["lost"] == 0
    assert sum(fl.stats()[m]["flush_faults"] for m in fl.models) > 0


def test_control_events_equal_reference():
    _, jt, _, t, _ = _incident()
    assert len(t.events) == len(jt.events)
    for i, (a, b) in enumerate(zip(jt.events, t.events)):
        assert _control(tr.jsonable(a)) == _control(b), i


def test_outputs_and_losses_within_tolerance():
    jfl, jt, fl, t, _ = _incident()
    for name, (atol, rtol) in (("kws", (KWS_ATOL, 0.0)),
                               ("darknet", (0.0, DN_RTOL))):
        want = {r.rid: (np.asarray(r.out), r.generation)
                for r in jfl.requests(name) if r.out is not None}
        got = {r.rid: r for r in fl.requests(name) if r.out is not None}
        assert want.keys() == got.keys() and want
        for rid, (w, gen) in want.items():
            assert got[rid].generation == gen
            tol = atol + rtol * np.abs(w).max() if gen == 0 \
                else RETRAINED_RTOL * np.abs(w).max()
            np.testing.assert_allclose(got[rid].out, w, rtol=0, atol=tol)
    assert any(r.generation > 0 for r in fl.requests("kws")
               if r.out is not None)
    jl = [e["loss"] for e in jt.of_type("retrain")]
    tl = [e["loss"] for e in t.of_type("retrain")]
    assert len(tl) == len(jl) > 0
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


def _generation_one(fl):
    m = fl._model("kws")
    if m.last_good is not None and m.last_good[1] == 1:
        return m.last_good[0]
    return m.stack


def test_swapped_stack_against_reference():
    jfl, jt, fl, t, _ = _incident()
    js, ts = jt.of_type("swap")[0], t.of_type("swap")[0]
    assert js["generation"] == ts["generation"] == 1
    jstack, tstack = _generation_one(jfl), _generation_one(fl)
    assert jii.stack_digest(jstack) == js["stack"]
    assert tii.stack_digest(tstack) == ts["stack"]
    differ, scalars_equal = 0, True
    for n in tstack.layer_names:
        differ += int((np.asarray(jstack[n]["w_codes"])
                       != tstack[n]["w_codes"].numpy()).sum())
        for k in ("rescale", "alpha"):
            if k in tstack[n]:
                a = float(np.asarray(jstack[n][k]))
                b = float(tstack[n][k])
                assert b == pytest.approx(a, rel=SCALAR_RTOL)
                scalars_equal &= a == b
    assert differ <= MAX_CODE_DIFF
    if differ == 0 and scalars_equal:
        assert ts["stack"] == js["stack"]


def test_generation_count_equals_reference():
    """C-ref-7: the count of swaps, flapping included, is the
    reference's."""
    jfl, _, fl, _, _ = _incident()
    assert fl.stats()["kws"]["generation"] == \
        jfl.stats()["kws"]["generation"] >= 1


def test_incident_replays_bit_exact():
    _, _, _, t, _ = _incident()
    rep = tr.replay(t, lambda cfg, fresh: _build("port", fresh))
    assert rep.bit_exact, rep.summary()


def test_job_result_rederives_the_swapped_stack():
    """The synced params the job handed over rederive, on the registered
    stack, into the stack the fleet swapped in (same digest)."""
    _, _, _, t, synced = _incident()
    assert synced
    _, ks, kst, _, _ = _inputs()["port"]
    again = kst.rederive({n: synced[0][n] for n in kst.layer_names},
                         extras=tkws.int_extras(synced[0], ks, KWS_CFGS[1]))
    assert tii.stack_digest(again) == t.of_type("swap")[0]["stack"]


@pytest.mark.cuda
@pytest.mark.skipif(not has_cuda(), reason="needs a CUDA device")
def test_two_lane_fleet_on_one_card_swaps_lane_by_lane():
    """The port's own reduced KWS stack (no reference on the card's
    machine) on two lanes of one card: each lane serves its own device
    copy, clean flushes replay graphs, the drift breaches, the swap
    installs lane 0 then lane 1, and the audit holds."""
    dev = torch.device("cuda", 0)
    stack, kp, ks = plt.port_stack("kws", device=dev)
    cfg = KWS_CFGS[1]
    x, y = tsyn.make_mfcc_dataset(
        prng.PRNGKey(5, device=dev), n=N_TRAIN + 16, seq_len=cfg.seq_len,
        n_mfcc=cfg.n_mfcc, num_classes=cfg.num_classes, noise=2.0)
    t = tr.Trace()
    fl = tfleet.FleetRuntime(trace=t)
    fl.register("kws", stack, lambda s: tkws.int_serve_fn(s, QCFG, cfg),
                slo=tfleet.ModelSLO(**KWS_SLO), probe=x[N_TRAIN:].cpu().numpy(),
                canary_seed=31,
                finetune_factory=lambda s, c: tfleet.QATFinetuneJob(
                    tkws, kp, ks, cfg, QCFG, c,
                    data=(x[:N_TRAIN], y[:N_TRAIN]), **FT),
                batcher_kw=dict(BATCHER, max_batch=8), n_replicas=2)
    fl.shapes = {"kws": (cfg.seq_len, cfg.n_mfcc)}
    cond = TABLE7_CONDITIONS[-1]
    for tick in range(PRE_TICKS + POST_TICKS):
        if tick == PRE_TICKS:
            fl.set_condition("kws", (cond.sigma_w, cond.sigma_a,
                                     cond.sigma_mac))
        fl.submit("kws", [tfleet.RequestSpec(rid=2 * tick + i, seed=3,
                                             shape=fl.shapes["kws"])
                          for i in range(2)])
        fl.tick()
    fl.drain()
    swaps = t.of_type("swap-replica")
    assert t.of_type("breach") and t.of_type("swap")
    assert [e["replica"] for e in swaps[:2]] == [0, 1]
    b = fl._model("kws").batcher
    assert b.step_stats["eager_flushes"] == 0
    assert b.step_stats["graph_flushes"] == b.stats["flushes"]
    assert fl.audit("kws")["exactly_once"]
