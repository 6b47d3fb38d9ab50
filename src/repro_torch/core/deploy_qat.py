"""Differentiable deployment forward: QAT against the integer noise field.

Counterpart of ``repro.core.deploy_qat``. The paper's Table 7 shows noise
resilience is best when the network is trained with the noise it will see
at deployment. The deployed noise field (``core.noise``, the kernels' K4
epilogue) is a stateless counter hash, so the QAT forward here IS the
deployed integer path, bit-identical with serving for the same key, sigma
and ``mac_chunks``.

Each unit is a ``torch.autograd.Function`` whose

  * **forward** converts the float FQ layer on the fly
    (``integer_inference.convert_layer(validate=False)``) and runs the
    integer path through ``kernels/ops``: the entry quantizer (K1) at the
    first layer, code-domain weight and activation noise, the conv kernel
    (K3, or K3b with a fused pool) and its ADC-noise epilogue (K4), exactly
    the ops ``int_apply`` runs;
  * **backward** re-runs the float FQ surrogate (``fq_layers`` in FQ mode,
    no noise) at the saved input under ``torch.enable_grad()`` and returns
    its vector-Jacobian product: the straight-through linearization of the
    quantizers around the values the deployed network actually saw.

Units thread a pair ``(h, codes)``: ``codes`` carry the bit-exact integer
stream (int8, no gradient), ``h`` the differentiable float stream whose
value is the decoded codes (``decode_output``, inside the forward, so
autograd never differentiates it) and whose gradient is the surrogate's.
Layer i's conversion and surrogate read layer i-1's ``s_out`` as their
``s_in``, so the stored inner ``s_in`` go stale by design and get a
gradient of exactly 0; run ``integer_inference.sync_handoff`` before
re-converting.

Per-step seeding: :func:`train_step_key` folds the step counter into the
run's key; the per-layer split below it is ``int_apply``'s, so any training
step's noise draw replays at serving bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops
from . import fq_layers as fql
from . import integer_inference as ii
from . import prng
from .noise import NoiseConfig
from .quant import QuantConfig, RELU_BOUND


def train_step_key(base_key: torch.Tensor, step: int) -> torch.Tensor:
    """Per-step noise key: ``fold_in(base_key, step)``, a pure function of
    the two, so a run resumed mid-way draws the same noise."""
    return prng.fold_in(base_key, step)


class _DeployUnit(torch.autograd.Function):
    """forward = the deployed integer path, backward = the float FQ/STE
    surrogate's VJP. ``fns`` = (int_fwd, float_fwd, bits_out) close over
    static config only; the tensors come in positionally (``Function.apply``
    sees no tensor inside a dict): the key and the codes (None at the entry
    or on the clean path; no gradient), ``s_in``, ``h``, then the layer's
    params in the order of ``names``."""

    @staticmethod
    def forward(ctx, fns, names, codes, key, s_in, h, *leaves):
        int_fwd, _, bits_out = fns
        p_eff = {**dict(zip(names, leaves)), "s_in": s_in}
        codes_out = int_fwd(p_eff, h, codes, key)
        h_out = ii.decode_output(codes_out, p_eff["s_out"], bits_out)
        ctx.fns, ctx.names = fns, names
        ctx.save_for_backward(s_in, h, *leaves)
        ctx.mark_non_differentiable(codes_out)
        return h_out, codes_out

    @staticmethod
    def backward(ctx, g_h, _g_codes):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        if not any(need):
            return (None,) * (4 + len(saved))
        # a leaf param is differentiated as itself (the same tensor object,
        # so hooks keyed by it, as repro_torch.taps' are, see it); h and
        # any non-leaf are cut from their graph
        live = [t if (n and t.is_leaf and i != 1)
                else t.detach().requires_grad_(n)
                for i, (t, n) in enumerate(zip(saved, need))]
        s_in, h, *leaves = live
        with torch.enable_grad():
            p = {**dict(zip(ctx.names, leaves)), "s_in": s_in}
            y = ctx.fns[1](p, h)
            wrt = [t for t, n in zip(live, need) if n]
            got = iter(torch.autograd.grad(y, wrt, g_h, allow_unused=True))
        grads = [next(got) if n else None for n in need]
        grads = [torch.zeros_like(t) if n and g is None else g
                 for t, n, g in zip(live, need, grads)]
        return (None, None, None, None, *grads)


def _deploy_unit(int_fwd, float_fwd, bits_out: int, p, s_in, h, codes, key):
    """``(h_out, codes_out)`` of one unit; the stored ``p["s_in"]`` is not
    an input (``s_in`` takes its place), so it gets no gradient."""
    names = tuple(sorted(k for k in p if k != "s_in"))
    return _DeployUnit.apply((int_fwd, float_fwd, bits_out), names, codes,
                             key, s_in, h, *(p[k] for k in names))


def qat_conv1d(p, h, codes, qcfg: QuantConfig, *, ksize: int,
               dilation: int = 1, s_in=None,
               noise: Optional[NoiseConfig] = None, rng=None,
               mac_chunks: int = 1, impl=None):
    """One KWS-style conv1d deploy-QAT unit. Returns ``(h_out, codes_out)``.

    ``codes=None`` marks the entry layer: the integer forward quantizes
    ``h`` to entry codes itself (K1, the op ``int_apply`` runs), and the
    surrogate's input quantizer supplies the matching STE gradient.
    ``s_in=None`` uses the layer's stored scale (entry); inner layers pass
    the previous layer's ``s_out``.
    """
    s_in = p["s_in"] if s_in is None else s_in

    def int_fwd(p_eff, h_, codes_, key):
        ip = ii.convert_layer(p_eff, qcfg, relu_out=True, validate=False)
        if codes_ is None:
            codes_ = ii.entry_codes(h_, p_eff, qcfg, b_in=RELU_BOUND)
        return ii.int_conv1d(ip, codes_, ksize=ksize, dilation=dilation,
                             impl=impl, noise=noise, rng=key,
                             mac_chunks=mac_chunks)

    def float_fwd(p_eff, h_):
        return fql.fq_conv1d(p_eff, h_, qcfg, dilation=dilation,
                             padding="VALID", b_in=RELU_BOUND, relu_out=True)

    return _deploy_unit(int_fwd, float_fwd, qcfg.bits_out, p, s_in, h, codes,
                        rng)


def qat_conv2d(p, h, codes, qcfg: QuantConfig, *, ksize: int,
               pool: Optional[int] = None, s_in=None,
               noise: Optional[NoiseConfig] = None, rng=None,
               mac_chunks: int = 1, impl=None):
    """One DarkNet-style SAME / stride-1 conv2d deploy-QAT unit, with the
    fused conv + max-pool (K3b) at ``pool=2``. Returns ``(h_out,
    codes_out)``; ``codes`` and ``s_in`` as in :func:`qat_conv1d`."""
    s_in = p["s_in"] if s_in is None else s_in

    def int_fwd(p_eff, h_, codes_, key):
        ip = ii.convert_layer(p_eff, qcfg, relu_out=True, validate=False)
        if codes_ is None:
            codes_ = ii.entry_codes(h_, p_eff, qcfg, b_in=RELU_BOUND)
        kw = dict(ksize=ksize, padding=ksize // 2, impl=impl, noise=noise,
                  rng=key, mac_chunks=mac_chunks)
        if pool is None:
            return ii.int_conv2d(ip, codes_, **kw)
        return ii.int_conv2d_pool(ip, codes_, pool=pool, **kw)

    def float_fwd(p_eff, h_):
        y = fql.fq_conv2d(p_eff, h_, qcfg, padding="SAME", b_in=RELU_BOUND,
                          relu_out=True)
        if pool is not None:
            if pool != 2:
                raise ValueError(f"qat_conv2d: the float pool is 2x2, got "
                                 f"pool={pool}")
            y = ops.maxpool2d(y)
        return y

    return _deploy_unit(int_fwd, float_fwd, qcfg.bits_out, p, s_in, h, codes,
                        rng)


def qat_maxpool2d(h, codes):
    """Standalone 2x2 max-pool on the ``(h, codes)`` pair: the float stream
    pooled with its gradient to the first maximum, the code stream by
    ``int_maxpool2d``. The quantizer is monotone, so the pair's value stays
    ``decode(codes)``."""
    return ops.maxpool2d(h), ii.int_maxpool2d(codes)
