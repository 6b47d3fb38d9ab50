"""Helpers of the float transformer zoo's parity tests (not a test file).

The port (``repro_torch.models.transformer`` and its mixers) is held
against the reference (``repro.models.transformer``) on the reference's
own params, carried across by ``interop.params_from_numpy``,
on numpy inputs made from a seed, in float32 with the archs' SMOKE
configs.

Both sides quantize activations (the archs' ``QuantConfig(8, 8)``), and
the two frameworks sum in other orders, so a quantizer input that lies
within float32 rounding of a half-LSB boundary can round to the next code
in one run and not the other (a rounding tie; one such tie moves a logit
by up to ~1% of its range, far past the float tolerance). So every
reference run records the input of each learned quantizer it calls, in
call order (an ordered debug callback, inside ``lax.scan`` and ``jit``
alike), and the port runs under ``repro_torch.taps.Taps`` on that record:
each code the port would round otherwise is counted and pinned to the
reference's input. A test then requires every counted code flip to be a
rounding tie (``Taps.round_ties``, both inputs within 2^-16 of the
boundary) and the logits within ``RTOL`` x max|logit|. A port that
computed anything else would flip codes far from any boundary and fail.

Reference calls are jitted through a fresh function each time, so that
its trace runs under the tap (a cached trace would record nothing).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import fq_layers as jfql
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch import interop, tree
from repro_torch.configs import get_arch
from repro_torch.core.quant import QuantConfig
from repro_torch.models import transformer as T
from repro_torch.taps import Taps, recorded

RTOL = 1e-4          # x max|logit|: float32 sums in other orders
B, S = 2, 12         # batch and total sequence of the arch cases
N_DECODE = 3         # decode steps after a prefill of S - 3 tokens


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread while a zoo test module runs: its ops are
    small, and the suite runs test files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(t):
    return jax.tree.map(np.asarray, t)


def tq(q) -> QuantConfig:
    """The port's QuantConfig of a reference one."""
    return QuantConfig(q.bits_w, q.bits_a, q.bits_out, q.fq)


def port_params(jparams):
    return interop.params_from_numpy(to_np(jparams), {}, device="cpu")[0]


@contextlib.contextmanager
def reference_taps():
    """The input of every learned quantizer the reference runs, in call
    order (``fq_layers`` and the MoE / MLA modules' direct calls)."""
    calls, orig = [], jfql.learned_quantize

    def tap(x, s, *, bits, b, stabilize=True):
        if bits is not None and bits < 32:
            jax.debug.callback(lambda v: calls.append(np.array(v)), x,
                               ordered=True)
        return orig(x, s, bits=bits, b=b, stabilize=stabilize)

    with contextlib.ExitStack() as stack:
        for mod in (jfql, jmoe, jmla):
            stack.enter_context(mock.patch.object(mod, "learned_quantize",
                                                  tap))
        yield calls


def run_reference(fn, *args, jit=True):
    """(fn(*args), the quantizer inputs it recorded); ``jit=False`` runs
    ``fn`` as it is (a host loop such as ``generate``)."""
    with reference_taps() as calls:
        f = jax.jit(lambda *a: fn(*a)) if jit else fn
        out = f(*args)
        jax.block_until_ready(out)
        jax.effects_barrier()
    return out, list(calls)


@contextlib.contextmanager
def traced_reference(fn):
    """``fn`` jitted once with the quantizer taps in its trace; yields
    ``run(*args) -> (fn(*args), its recorded inputs)`` for steps of one
    shape (one compile, however many steps)."""
    with reference_taps() as rec:
        jf = jax.jit(lambda *a: fn(*a))

        def run(*args):
            del rec[:]
            out = jf(*args)
            jax.block_until_ready(out)
            jax.effects_barrier()
            return out, list(rec)
        yield run


def run_port(fn, calls):
    """(fn(), its Taps) with the port's quantizer inputs pinned to the
    reference's ``calls`` where they round to another code."""
    taps = Taps(recorded(calls=calls))
    with taps, torch.no_grad():
        out = fn()
    taps.matched()
    return out, taps


def assert_ties_only(taps, label=""):
    """Every code the port rounded otherwise was a rounding tie."""
    assert taps.code_flips == taps.round_ties, (
        f"{label}: {taps.code_flips} code flips, {taps.round_ties} of them "
        f"rounding ties, of {taps.positions} quantized values")


def assert_close(got, want, label="", rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    tol = rtol * float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol, f"{label}: max |diff| {err:.3g} > {tol:.3g}"


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _leaf_bits(a, b) -> bool:
    """A reference leaf (numpy) and a port leaf (tensor): same dtype name,
    shape and bytes (bfloat16 compared as its 2-byte words)."""
    a, b = np.asarray(a), b.detach().cpu()
    if b.dtype == torch.bfloat16:
        return (a.dtype.name == "bfloat16" and a.shape == tuple(b.shape)
                and a.tobytes() == b.view(torch.int16).numpy().tobytes())
    return bits_equal(a, b.numpy())


def tree_bits_equal(jtree, ttree):
    """Leaf names whose dtype, shape or bytes differ, over the sorted-key
    leaf order both trees share."""
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = tree.named_leaves(ttree)
    assert len(jl) == len(tl), (len(jl), len(tl))
    return [name for (_, a), (name, b) in zip(jl, tl)
            if not _leaf_bits(a, b)]


@dataclasses.dataclass
class ArchCase:
    arch_id: str
    jcfg: object
    cfg: object
    jq: object
    q: QuantConfig
    jparams: dict
    params: dict
    jbatch: dict
    batch: dict
    n_vis: int


def inputs(cfg, seed, b=B, s=S):
    """Tokens (and frontend features) of (b, s) total positions."""
    rng = np.random.default_rng(seed)
    n_vis = cfg.frontend.n_positions if (cfg.frontend.enabled
                                         and not cfg.enc_dec) else 0
    toks = rng.integers(0, cfg.vocab, (b, s - n_vis)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.frontend.enabled:
        f = rng.standard_normal((b, cfg.frontend.n_positions,
                                 cfg.frontend.feat_dim)).astype(np.float32)
        jb["feats"], tb["feats"] = jnp.asarray(f), torch.from_numpy(f)
    return jb, tb, n_vis


@functools.lru_cache(maxsize=None)
def arch_case(arch_id: str, seed: int = 0) -> ArchCase:
    """The arch's smoke config on both sides, the reference's params
    (``make_params(key(seed))``) carried to the port, inputs from ``seed``."""
    ja, a = jget_arch(arch_id), get_arch(arch_id)
    jcfg, cfg = ja.smoke, a.smoke
    jparams = jax.jit(lambda k: JT.make_params(k, jcfg))(jax.random.key(seed))
    jbatch, batch, n_vis = inputs(jcfg, seed + 1)
    return ArchCase(arch_id, jcfg, cfg, ja.qcfg, tq(ja.qcfg), jparams,
                    port_params(jparams), jbatch, batch, n_vis)


def check_counts(c: ArchCase):
    assert T.count_params(c.cfg) == JT.count_params(c.jcfg)
    assert T.count_active_params(c.cfg) == JT.count_active_params(c.jcfg)


def check_forward(c: ArchCase):
    (jl, jaux), calls = run_reference(
        lambda p, b: JT.forward(p, b, c.jcfg, c.jq), c.jparams, c.jbatch)
    (tl, taux), taps = run_port(
        lambda: T.forward(c.params, c.batch, c.cfg, c.q), calls)
    assert_ties_only(taps, f"{c.arch_id} forward")
    assert_close(tl, jl, f"{c.arch_id} forward logits")
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def check_prefill_decode(c: ArchCase, n_decode: int = N_DECODE):
    """prefill of the first S - n_decode text tokens, then ``n_decode``
    decode steps, each step's logits and the caches against the
    reference's."""
    toks_j, toks_t = c.jbatch["tokens"], c.batch["tokens"]
    n_pre = toks_t.shape[1] - n_decode
    jb = dict(c.jbatch, tokens=toks_j[:, :n_pre])
    tb = dict(c.batch, tokens=toks_t[:, :n_pre])
    max_len = S + 2
    (jl, jc), calls = run_reference(
        lambda p, b: JT.prefill(p, b, c.jcfg, c.jq, max_len=max_len),
        c.jparams, jb)
    (tl, tc), taps = run_port(
        lambda: T.prefill(c.params, tb, c.cfg, c.q, max_len=max_len), calls)
    assert_ties_only(taps, f"{c.arch_id} prefill")
    assert_close(tl, jl, f"{c.arch_id} prefill logits")
    check_caches(jc, tc, f"{c.arch_id} prefill")
    with traced_reference(lambda p, cc, t: JT.decode_step(
            p, cc, t, c.jcfg, c.jq)) as step:
        steps = []
        for i in range(n_pre, n_pre + n_decode):
            (jl, jc), calls = step(c.jparams, jc, toks_j[:, i:i + 1])
            steps.append((jl, jc, calls))
    for i, (jl, jc, calls) in zip(range(n_pre, n_pre + n_decode), steps):
        (tl, tc), taps = run_port(
            lambda: T.decode_step(c.params, tc, toks_t[:, i:i + 1], c.cfg,
                                  c.q), calls)
        assert_ties_only(taps, f"{c.arch_id} decode {i}")
        assert_close(tl, jl, f"{c.arch_id} decode {i}")
        check_caches(jc, tc, f"{c.arch_id} decode {i}")


def check_caches(jc, tc, label):
    """Integer leaves (positions, slot positions) equal; float leaves
    within RTOL of their largest magnitude; int8 KV codes at most 1 apart
    (codes of float K / V that sum in other orders)."""
    jl = jax.tree_util.tree_flatten_with_path(jc)[0]
    tl = tree.named_leaves(tc)
    assert len(jl) == len(tl), label
    for (_, a), (name, b) in zip(jl, tl):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (label, name)
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b).max(initial=0) <= 1, (label,
                                                                   name)
        elif np.issubdtype(a.dtype, np.integer):
            assert np.array_equal(a, b), (label, name)
        else:
            tol = RTOL * max(float(np.abs(a).max(initial=0)), 1e-30)
            err = float(np.abs(a.astype(np.float64) - b).max(initial=0))
            assert err <= tol, f"{label} {name}: {err:.3g} > {tol:.3g}"


def check_serving_codes(c: ArchCase):
    """``quantize_params_for_serving``: every leaf bit for bit (codes,
    ``w_scale`` and the leaves it keeps)."""
    jq = to_np(JT.quantize_params_for_serving(c.jparams, 8))
    tqp = T.quantize_params_for_serving(c.params, 8)
    assert tree_bits_equal(jq, tqp) == []


def jitted_prefill():
    """The reference's ``transformer.prefill`` jitted while the context
    lasts (its ``generate`` and batcher call it eagerly: one compile beats
    eager dispatch of every layer), through a fresh function, so that its
    trace runs under the caller's tap."""
    orig = JT.prefill

    def prefill(params, batch, cfg, qcfg, *, max_len=None):
        return orig(params, batch, cfg, qcfg, max_len=max_len)
    return mock.patch.object(JT, "prefill", jax.jit(
        prefill, static_argnums=(2, 3), static_argnames=("max_len",)))


def check_generate(c: ArchCase, max_new: int = 4):
    """Greedy ``generate`` tokens (B = 2) equal the reference's (its
    ``generate`` loop, the prefill it calls jitted)."""
    from repro.serve.decode import generate as jgenerate
    from repro_torch.serve.decode import generate
    jb, tb = c.jbatch, c.batch
    with jitted_prefill():
        jtok, calls = run_reference(
            lambda: jgenerate(c.jparams, c.jcfg, c.jq, jb, max_new=max_new),
            jit=False)
    ttok, taps = run_port(
        lambda: generate(c.params, c.cfg, c.q, tb, max_new=max_new), calls)
    assert_ties_only(taps, f"{c.arch_id} generate")
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


# -- training (loss_fn, gradients, train steps) -----------------------------

GRAD_RTOL = 1e-4     # relative L2 a leaf: float32 sums in other orders
LOSS_RTOL = 1e-5


def no_remat(c: ArchCase):
    """(reference config, port config) of the case with remat off: a
    remat unit runs its quantizers again in the backward, so the taps'
    call order would no longer match."""
    return (dataclasses.replace(c.jcfg, remat=False),
            dataclasses.replace(c.cfg, remat=False))


def with_labels(c: ArchCase, seed: int):
    """The case's batches with labels (B, S_text) drawn from ``seed``, the
    first and the last masked (-1)."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, c.cfg.vocab, tuple(c.batch["tokens"].shape)
                       ).astype(np.int32)
    lab[0, 0] = lab[-1, -1] = -1
    return (dict(c.jbatch, labels=jnp.asarray(lab)),
            dict(c.batch, labels=torch.from_numpy(lab)))


C_S = 1e-4           # x M, a log-scale's gradient (ROADMAP C14)


def reference_grad(c: ArchCase, fn, forward, *args):
    """(``fn(*args)`` jitted, the quantizer inputs to pin the port to).
    The inputs come from that run, except for an encoder-decoder arch:
    differentiated, the reference hoists its cross-attention's K / V input
    quantizers (of the encoder output, one a layer) and merges the two of
    a layer, whose inputs and scales are equal; so its inputs come from
    ``forward(*args)``, the same forward undifferentiated."""
    out, calls = run_reference(fn, *args)
    if c.jcfg.enc_dec:
        _, calls = run_reference(forward, *args)
    return out, calls


def port_loss_grad(loss, params, calls):
    """``((value, aux), {path: grad}), taps`` of ``loss(params) -> (value,
    aux)`` under Taps pinned to the reference's ``calls``
    (``repro_torch.taps.value_and_grad``: each log-scale's terms'
    magnitude M in ``taps.mag``, their forward difference D in
    ``taps.fwd``)."""
    from repro_torch.taps import value_and_grad
    taps = Taps(recorded(calls=calls))
    out = value_and_grad(loss, params, taps)
    taps.matched()
    return out, taps


def port_grad_mag(loss, params):
    """``((value, aux), {path: grad}), taps`` of the port alone, its taps
    summing each log-scale's M (``taps.mag``) and pinning nothing."""
    from repro_torch.taps import value_and_grad
    taps = Taps()
    return value_and_grad(loss, params, taps), taps


def assert_grads_close(jgrads, grads, taps, label, rtol=GRAD_RTOL):
    """The port's gradients ({path: grad}) against the reference's tree:
    each log-scale within C_S x M + 2 D (its terms cancel, so float32 sums
    in two orders part by ~eps M whatever the result: ROADMAP C14), every
    other leaf within ``rtol`` relative L2."""
    jl = (jax.tree_util.tree_flatten_with_path(jgrads)[0]
          if not isinstance(jgrads, dict) or not all(
              isinstance(v, torch.Tensor) for v in jgrads.values())
          else [(k, v.numpy()) for k, v in jgrads.items()])
    assert len(jl) == len(grads), (label, len(jl), len(grads))
    bad = []
    for (_, a), (name, b) in zip(jl, grads.items()):
        a = np.asarray(a).astype(np.float64)
        assert tuple(a.shape) == tuple(b.shape), (label, name)
        # a log-scale, or a stack of them (a layer's slice "name[i:j]")
        parts = ([(name, 0, a.size)] if name in taps.mag else
                 [(k, *map(int, k[len(name) + 1:-1].split(":")))
                  for k in taps.mag if k.startswith(name + "[")])
        if sum(j - i for _, i, j in parts) == a.size:
            err = np.abs(b.double().numpy() - a).ravel()
            for k, i, j in parts:
                lim = C_S * taps.mag[k] + 2.0 * taps.fwd.get(k, 0.0)
                if err[i:j].max() > lim:
                    bad.append((k, float(err[i:j].max()), lim))
        elif rel_l2(b, a) > rtol:
            bad.append((name, rel_l2(b, a)))
    assert not bad, f"{label}: gradients past their bounds: {bad[:8]}"


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| (float64); a zero ``want`` takes an
    absolute ||got||."""
    got = got.detach().double().cpu().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want).astype(np.float64)
    d = float(np.linalg.norm((got - want).ravel()))
    n = float(np.linalg.norm(want.ravel()))
    return d / n if n else d


def assert_trees_close(jtree, ttree, label, rtol=GRAD_RTOL):
    """Every leaf within ``rtol`` relative L2 (same shapes, leaf order)."""
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = tree.named_leaves(ttree)
    assert len(jl) == len(tl), (label, len(jl), len(tl))
    bad = []
    for (_, a), (name, b) in zip(jl, tl):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        assert tuple(a.shape) == tuple(b.shape), (label, name)
        e = rel_l2(b.float() if b.is_floating_point() else b, a)
        if e > rtol:
            bad.append((name, e))
    assert not bad, f"{label}: leaves past {rtol}: {bad[:8]}"


def assert_metrics_close(jm, tm, label, rtol=LOSS_RTOL):
    for k, v in jm.items():
        want, got = float(v), float(tm[k].detach())
        assert abs(got - want) <= rtol * abs(want) + 1e-12, (label, k, got,
                                                             want)
