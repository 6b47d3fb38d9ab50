"""AdamW of the port (``optim.adam``) against the reference's.

* the bias corrections ``1 - b ** t`` bit for bit for t = 1..1000;
* float32 moments and updated params within 1e-6 relative of the
  reference's update over 5 steps (run eagerly and jitted), from the same
  params and gradients, on float32 and bfloat16 leaves;
* int8 moments: codes equal, every differing code a rounding tie of the
  reference's own value, scales within 1e-6;
* a state carried across from the reference (``interop``) continues as the
  reference's does;
* the reference's ``tests/test_optim.py`` Adam cases on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam as jadam
from repro.optim import schedules as jsched
from repro_torch import interop, tree
from repro_torch.optim import adam, schedules

RTOL = 1e-6
STEPS = 5
SHAPES = {"a": ((7, 33), "float32"), "b": ((5,), "float32"),
          "c": ((3, 4, 20), "bfloat16"), "d": ((), "float32")}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(s) * 0.5, np.float32)
            for k, (s, _) in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: np.asarray(rng.standard_normal(s) * 10.0 ** -(step % 3),
                          np.float32) for k, (s, _) in SHAPES.items()}


def _j(tree_):
    return {k: jnp.asarray(v, getattr(jnp, SHAPES[k][1]))
            for k, v in tree_.items()}


def _t(tree_):
    return {k: torch.from_numpy(v).to(getattr(torch, SHAPES[k][1]))
            for k, v in tree_.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.abs(got - want).max(initial=0)) / max(
        float(np.abs(want).max(initial=0)), 1e-30)


@pytest.mark.parametrize("b", [0.9, 0.999, 0.95, 0.98])
def test_bias_corrections_bit_equal(b):
    t = jnp.arange(1, 1001, dtype=jnp.int32)
    want = np.asarray(1.0 - b ** t.astype(jnp.float32))
    got = np.array([adam.bias_correction(b, int(i)) for i in range(1, 1001)],
                   np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _both(moment_bits, wd, jit):
    kw = dict(weight_decay=wd, moment_bits=moment_bits)
    jopt = jadam.make(jsched.wsd(1e-2, 20), **kw)
    topt = adam.make(schedules.wsd(1e-2, 20), **kw)
    jupd = jax.jit(jopt.update) if jit else jopt.update
    return jopt, topt, jupd


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_float32_moments_and_updates(jit, wd):
    jopt, topt, jupd = _both(None, wd, jit)
    jp, tp = _j(_params()), _t(_params())
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts["count"].dtype == torch.int32 and ts["count"].device.type \
        == "cpu"
    for step in range(STEPS):
        g = _grads(step)
        jp, js = jupd(jp, _j(g), js, jnp.int32(step))
        tp, ts = topt.update(tp, _t(g), ts, step)
        for k in SHAPES:
            assert tp[k].dtype == getattr(torch, SHAPES[k][1])
            assert ts["mom"][k]["m"].dtype == torch.float32
            # a bfloat16 leaf: the float32 update, rounded to bfloat16
            tol = RTOL if SHAPES[k][1] == "float32" else 2 ** -7
            assert _rel(tp[k], jp[k]) <= tol, (step, k)
            for m in ("m", "v"):
                assert _rel(ts["mom"][k][m], js["mom"][k][m]) <= RTOL, (
                    step, k, m)
        assert int(ts["count"]) == int(js["count"]) == step + 1


def _ties(codes, want, m32, scale):
    """Codes that differ from the reference's, and of those the ones whose
    value (``m32 / scale`` in the reference's float32) lies within 2^-16
    LSB of the half-LSB boundary between the two codes."""
    diff = codes.astype(int) != want.astype(int)
    u = m32.astype(np.float64) / float(scale)
    mid = (codes.astype(np.float64) + want) / 2
    near = np.abs(u - mid) <= 2.0 ** -16 * np.maximum(np.abs(mid), 1)
    one = np.abs(codes.astype(int) - want) == 1
    return int(diff.sum()), int((diff & near & one).sum())


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_int8_moments(jit):
    jopt, topt, jupd = _both(8, 0.1, jit)
    jp, tp = _j(_params(1)), _t(_params(1))
    js, ts = jopt.init(jp), topt.init(tp)
    for k in SHAPES:
        assert ts["mom"][k]["m"].dtype == torch.int8
        assert ts["mom"][k]["m_s"].dtype == torch.float32
    total = [0, 0]
    for step in range(STEPS):
        g = _grads(step)
        # the reference's float32 moments of this step, before requant
        m_prev = {k: jadam._dq8(js["mom"][k]["m"], js["mom"][k]["m_s"])
                  for k in SHAPES}
        v_prev = {k: jadam._dq8(js["mom"][k]["v"], js["mom"][k]["v_s"])
                  for k in SHAPES}
        jp, js = jupd(jp, _j(g), js, jnp.int32(step))
        tp, ts = topt.update(tp, _t(g), ts, step)
        for k in SHAPES:
            gk = np.asarray(_j(g)[k].astype(jnp.float32))
            for name, prev, b in (("m", m_prev, 0.9), ("v", v_prev, 0.999)):
                new = (b * prev[k] + (1 - b) * gk if name == "m"
                       else b * prev[k] + (1 - b) * gk * gk)
                assert _rel(ts["mom"][k][name + "_s"],
                            js["mom"][k][name + "_s"]) <= RTOL
                n, ties = _ties(ts["mom"][k][name].numpy(),
                                np.asarray(js["mom"][k][name]),
                                np.asarray(new), js["mom"][k][name + "_s"])
                assert n == ties, (step, k, name, n, ties)
                total[0] += n
                total[1] += ties
            tol = RTOL if SHAPES[k][1] == "float32" else 2 ** -7
            assert _rel(tp[k], jp[k]) <= tol, (step, k)
    assert total[0] == total[1]


@pytest.mark.parametrize("bits", [None, 8])
def test_state_carried_from_reference(bits):
    """Two reference steps, the state and params carried across, then three
    more steps on each side."""
    jopt, topt, jupd = _both(bits, 0.1, False)
    jp = _j(_params(2))
    js = jopt.init(jp)
    for step in range(2):
        jp, js = jupd(jp, _j(_grads(step)), js, jnp.int32(step))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), {},
                                   device="cpu")[0]
    ts = interop.opt_state_from_numpy(jax.tree.map(np.asarray, js),
                                      device="cpu")
    assert int(ts["count"]) == 2 and ts["count"].device.type == "cpu"
    for k in SHAPES:
        assert ts["mom"][k]["m"].dtype == (torch.int8 if bits
                                           else torch.float32)
    for step in range(2, 5):
        g = _grads(step)
        jp, js = jupd(jp, _j(g), js, jnp.int32(step))
        tp, ts = topt.update(tp, _t(g), ts, step)
    for k in SHAPES:
        tol = RTOL if SHAPES[k][1] == "float32" else 2 ** -7
        assert _rel(tp[k], jp[k]) <= tol, k


def test_donate_writes_in_place():
    """The update writes the new params and state into the tensors it was
    given and returns them, with float32 and int8 moments and a bfloat16
    leaf; the values are those of an update of copies, and moved."""
    for bits in (None, 8):
        topt = adam.make(schedules.constant(1e-2), weight_decay=0.1,
                         moment_bits=bits)
        tp = _t(_params(3))
        ts = topt.init(tp)
        before = tree.map(torch.clone, tp)
        ref_p, ref_s = topt.update(tree.map(torch.clone, tp), _t(_grads(0)),
                                   tree.map(torch.clone, ts), 0)
        ids = [id(x) for x in tree.leaves(tp) + tree.leaves(ts)]
        new_p, new_s = topt.update(tp, _t(_grads(0)), ts, 0)
        assert [id(x) for x in tree.leaves(new_p) + tree.leaves(new_s)] \
            == ids
        for a, b in zip(tree.leaves(new_p) + tree.leaves(new_s),
                        tree.leaves(ref_p) + tree.leaves(ref_s)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert int(new_s["count"]) == 1
        assert all(not torch.equal(a, b) for a, b in zip(
            tree.leaves(new_p), tree.leaves(before)))


# -- the reference's tests/test_optim.py Adam cases, on the port -----------

def _quadratic_steps(opt, steps=200):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"x": torch.zeros(3)}
    state = opt.init(params)
    for i in range(steps):
        g = {"x": 2.0 * (params["x"] - target)}
        params, state = opt.update(params, g, state, i)
    return float(torch.linalg.norm(params["x"] - target))


def test_adam_converges():
    assert _quadratic_steps(adam.make(schedules.constant(0.1))) < 1e-3


def test_adam_int8_moments_converge():
    opt = adam.make(schedules.constant(0.1), moment_bits=8)
    assert _quadratic_steps(opt) < 5e-2


def test_adam_int8_state_is_int8():
    opt = adam.make(schedules.constant(0.1), moment_bits=8)
    st = opt.init({"w": torch.ones((4, 4))})
    assert st["mom"]["w"]["m"].dtype == torch.int8
    assert st["mom"]["w"]["v"].dtype == torch.int8


def test_adam_weight_decay_decoupled():
    """Decay applies with a zero gradient, as the reference's: p - lr wd p,
    equal to the reference's update."""
    jopt = jadam.make(jsched.constant(0.01), weight_decay=0.1)
    topt = adam.make(schedules.constant(0.01), weight_decay=0.1)
    p2, _ = topt.update({"w": torch.ones(3) * 5.0}, {"w": torch.zeros(3)},
                        topt.init({"w": torch.ones(3)}), 0)
    jp2, _ = jopt.update({"w": jnp.ones(3) * 5.0}, {"w": jnp.zeros(3)},
                         jopt.init({"w": jnp.ones(3)}), jnp.int32(0))
    assert float(p2["w"][0]) < 5.0
    np.testing.assert_array_equal(p2["w"].numpy(), np.asarray(jp2["w"]))
