"""The float transformer zoo's loss and gradients on the port against the
reference, for all ten archs at their SMOKE configs (float32).

From the reference's params (``interop``) and the same numpy batch with
labels, ``models.transformer.loss_fn``'s loss, ``ce`` and MoE aux terms
agree within 1e-5 relative and every leaf's gradient within 1e-4 relative
L2. The reference is jitted once an arch with an ordered tap of every
quantizer input; the port runs under ``repro_torch.taps.Taps`` pinned to
it, and every code it rounds otherwise must be a rounding tie
(``tests/torch_zoo_ref.py``). Both sides run with remat off (a remat unit
re-runs its quantizers in the backward); the port's remat on is then held
bit for bit against remat off, and its chunked cross-entropy against the
unchunked one.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_zoo_ref as Z
from repro.models import transformer as JT
from repro_torch import tree
from repro_torch.configs import ARCH_IDS
from repro_torch.models import transformer as T

one_thread = Z.one_thread


def _port_loss_grad(c, cfg, batch):
    return tree.value_and_grad(
        lambda p: T.loss_fn(p, batch, cfg, c.q), has_aux=True)(c.params)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_loss_and_grads(arch_id):
    c = Z.arch_case(arch_id)
    jcfg, cfg = Z.no_remat(c)
    jb, tb = Z.with_labels(c, 7)
    ((jl, jm), jg), calls = Z.reference_grad(
        c, lambda p, b: jax.value_and_grad(
            lambda pp: JT.loss_fn(pp, b, jcfg, c.jq), has_aux=True)(p),
        lambda p, b: JT.loss_fn(p, b, jcfg, c.jq), c.jparams, jb)
    ((tl, tm), tg), taps = Z.port_loss_grad(
        lambda p: T.loss_fn(p, tb, cfg, c.q), c.params, calls)
    Z.assert_ties_only(taps, f"{arch_id} loss_fn")
    Z.assert_metrics_close({"loss": jl, **jm}, {"loss": tl, **tm}, arch_id)
    Z.assert_grads_close(jg, tg, taps, f"{arch_id} gradients")
    assert all(np.isfinite(g.numpy()).all() for g in tg.values())


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_remat_bit_identical(arch_id):
    """remat on (a checkpoint unit a prefix / remainder block, a group and
    an encoder layer) gives remat off's loss and gradients bit for bit."""
    c = Z.arch_case(arch_id)
    _, off = Z.no_remat(c)
    on = dataclasses.replace(off, remat=True)
    _, tb = Z.with_labels(c, 8)
    (l0, m0), g0 = _port_loss_grad(c, off, tb)
    (l1, m1), g1 = _port_loss_grad(c, on, tb)
    assert torch.equal(l0, l1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for (name, a), b in zip(tree.named_leaves(g0), tree.leaves(g1)):
        assert torch.equal(a, b), name


def test_remat_checkpoints_units(monkeypatch):
    """With remat on, each prefix / remainder block, group and encoder
    layer is one checkpoint; none under no_grad (serving)."""
    counts = []
    orig = T.checkpoint

    def counted(fn, *a, **kw):
        counts.append(1)
        return orig(fn, *a, **kw)

    monkeypatch.setattr(T, "checkpoint", counted)
    for arch_id in ("deepseek-v2-lite-16b", "recurrentgemma-2b",
                    "whisper-tiny"):
        c = Z.arch_case(arch_id)
        cfg = dataclasses.replace(c.cfg, remat=True)
        prefix, n_groups, rem = cfg.layer_specs()
        units = len(prefix) + n_groups + len(rem) + (
            cfg.n_enc_layers if cfg.enc_dec else 0)
        _, tb = Z.with_labels(c, 9)
        del counts[:]
        _port_loss_grad(c, cfg, tb)
        assert len(counts) == units, arch_id
        del counts[:]
        with torch.no_grad():
            T.loss_fn(c.params, tb, cfg, c.q)
        assert not counts, arch_id


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_chunked_ce_equals_unchunked(arch_id):
    """Chunks of 4 positions against the whole sequence at once: the loss
    within 1e-6, the gradients within 1e-5 relative L2 (a log-scale's
    within C_S x M: the sums differ in order only)."""
    c = Z.arch_case(arch_id)
    _, cfg = Z.no_remat(c)
    _, tb = Z.with_labels(c, 10)
    chunked = dataclasses.replace(cfg, loss_chunk=4)
    ((l0, m0), g0), taps = Z.port_grad_mag(
        lambda p: T.loss_fn(p, tb, cfg, c.q), c.params)
    ((l1, m1), g1), _ = Z.port_grad_mag(
        lambda p: T.loss_fn(p, tb, chunked, c.q), c.params)
    assert abs(float(l1) - float(l0)) <= 1e-6 * abs(float(l0))
    Z.assert_metrics_close(m0, m1, arch_id, rtol=1e-6)
    Z.assert_grads_close(g0, g1, taps, f"{arch_id} chunked", rtol=1e-5)


def test_chunked_ce_against_reference():
    """The tied huge-vocab arch's chunked loss (3 chunks) and gradients
    against the reference's chunked scan."""
    c = Z.arch_case("minicpm-2b")
    jcfg, cfg = Z.no_remat(c)
    jcfg = dataclasses.replace(jcfg, loss_chunk=4)
    cfg = dataclasses.replace(cfg, loss_chunk=4)
    jb, tb = Z.with_labels(c, 11)
    ((jl, jm), jg), calls = Z.reference_grad(
        c, lambda p, b: jax.value_and_grad(
            lambda pp: JT.loss_fn(pp, b, jcfg, c.jq), has_aux=True)(p),
        lambda p, b: JT.loss_fn(p, b, jcfg, c.jq), c.jparams, jb)
    ((tl, tm), tg), taps = Z.port_loss_grad(
        lambda p: T.loss_fn(p, tb, cfg, c.q), c.params, calls)
    Z.assert_ties_only(taps, "minicpm chunked")
    Z.assert_metrics_close({"loss": jl, **jm}, {"loss": tl, **tm}, "chunked")
    Z.assert_grads_close(jg, tg, taps, "minicpm chunked gradients")


def test_ce_masks_and_vision_prefix():
    """``_ce`` over masked labels equals the mean over the kept positions;
    a vision prefix takes no loss (internvl2-1b: the loss of a batch whose
    labels cover the text only)."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 7)).astype(
        np.float32))
    labels = torch.tensor([[1, -1, 3, 4, -1], [0, 6, -1, 2, 5]])
    keep = labels >= 0
    want = -torch.log_softmax(logits, -1)[keep].gather(
        -1, labels[keep][:, None])[:, 0].mean()
    assert abs(float(T._ce(logits, labels)) - float(want)) <= 1e-6
    assert float(T._ce(logits, torch.full((2, 5), -1))) == 0.0
    c = Z.arch_case("internvl2-1b")
    _, cfg = Z.no_remat(c)
    _, tb = Z.with_labels(c, 12)
    with torch.no_grad():
        logits, _ = T.forward(c.params, tb, cfg, c.q)
        loss, m = T.loss_fn(c.params, tb, cfg, c.q)
    assert logits.shape[1] == c.n_vis + tb["labels"].shape[1]
    want = T._ce(logits[:, c.n_vis:], tb["labels"])
    assert torch.equal(m["ce"], want)
