"""AdamW, with optional int8 moment storage: counterpart of
``repro.optim.adam``.

Decoupled weight decay Adam for the LM archs. ``moment_bits=8`` stores both
moments as int8 codes with one per-tensor abs-max scale (the paper's
quantize-everything idea applied to the optimizer state): 2 bytes of moments
a parameter instead of 8. Each update dequantizes, updates in float32 and
requantizes a whole leaf, so a code's scale spans the whole (stacked) leaf,
as the reference's does.

``update`` writes the new params and state into the tensors it was given
and returns them, as the reference's jitted train step donates its buffers:
a step holds one copy of each (at minicpm-2b's full width the params are
5.45 GB and the float32 moments 21.8 GB).

The expressions and their order are the reference's. Three things keep the
values its bits on every device:

  * the bias corrections ``c = 1 - b ** t`` are taken on the host: ``b ** t``
    in float64 rounded to float32, which equals XLA's float32 ``pow`` for
    b1 = 0.9 and b2 = 0.999 at every t up to 2,957 (``c2`` is first one ulp
    off at t = 2,958); the step counter ``count`` stays on the host (a 0-d
    int32 CPU tensor), so reading it costs no device sync;
  * every division is tensor by tensor (C7), the divisors on the operand's
    device: CUDA turns ``t / <host scalar>`` into a reciprocal multiply;
  * ``sqrt`` on the CPU is numpy's (``core.quant.sqrt``, C8).

``state_specs`` (the state's sharding on a mesh) comes with the mesh slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tree
from ..core.quant import sqrt
from .sgd import Optimizer

_F32 = torch.float32
_CPU_CHUNK = 1 << 20       # elements a pass on the CPU (4 MB of float32)


def _q8(x: torch.Tensor):
    """Per-tensor abs-max int8 quantization -> (codes, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.div(torch.clamp_min(amax, 1e-20),
                      torch.full_like(amax, 127.0))
    return torch.round(torch.div(x, scale)).to(torch.int8), scale


def _dq8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(_F32) * scale


def bias_correction(b: float, t: int) -> float:
    """``1 - b ** t`` in float32 as the reference computes it (module
    doc)."""
    return float(np.float32(1.0) - np.float32(float(np.float32(b)) ** t))


def make(lr_fn, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, moment_bits: Optional[int] = None
         ) -> Optimizer:
    quant = moment_bits == 8

    def init(params):
        if quant:
            def zero(p):
                z = torch.zeros((), dtype=_F32, device=p.device)
                return {"m": torch.zeros(p.shape, dtype=torch.int8,
                                         device=p.device),
                        "m_s": z, "v": torch.zeros(p.shape, dtype=torch.int8,
                                                   device=p.device),
                        "v_s": z.clone()}
        else:
            def zero(p):
                return {"m": torch.zeros(p.shape, dtype=_F32,
                                         device=p.device),
                        "v": torch.zeros(p.shape, dtype=_F32,
                                         device=p.device)}
        return {"mom": tree.map(zero, params),
                "count": torch.zeros((), dtype=torch.int32)}

    def update(params, grads, state, step):
        """``(params, state)``, the new values written into the given
        tensors."""
        lr = lr_fn(step)
        t = int(state["count"]) + 1
        c1, c2 = bias_correction(b1, t), bias_correction(b2, t)
        consts = {}

        def const(dev):
            if dev not in consts:
                consts[dev] = torch.tensor([c1, c2], dtype=_F32,
                                           device=dev).unbind()
            return consts[dev]

        def upd(p, g, mom):
            g = g.to(_F32)
            if quant:
                m = _dq8(mom["m"], mom["m_s"])
                v = _dq8(mom["v"], mom["v_s"])
            else:
                m, v = mom["m"], mom["v"]
            p32 = p.to(_F32)      # p itself when p is float32
            k1, k2 = const(p.device)
            n = p.numel()
            # the reference's expressions in its order, each op writing into
            # a buffer it owns; on the CPU a chunk of the leaf at a time, so
            # the scratch stays small and warm (fresh host memory costs more
            # than the arithmetic); on the card the whole leaf at once
            step = n if p.device.type != "cpu" else _CPU_CHUNK
            t = torch.empty(min(n, step), dtype=_F32, device=p.device)
            d = torch.empty_like(t)
            gf = g.reshape(-1)
            mf, vf, pf = (x.view(-1) for x in (m, v, p32))
            for a in range(0, n, step):
                z = min(a + step, n)
                tt, dd, gg = t[:z - a], d[:z - a], gf[a:z]
                torch.mul(gg, 1 - b1, out=tt)
                mf[a:z].mul_(b1).add_(tt)
                torch.mul(gg, 1 - b2, out=tt).mul_(gg)
                vf[a:z].mul_(b2).add_(tt)
                sqrt(torch.div(vf[a:z], k2, out=tt), out=tt).add_(eps)
                torch.div(mf[a:z], k1, out=dd).div_(tt)
                if weight_decay:
                    dd.add_(torch.mul(pf[a:z], weight_decay, out=tt))
                pf[a:z].sub_(dd.mul_(lr))
            del g, t, d
            if p32 is not p:
                p.copy_(p32)
            if quant:
                for k, x in zip(("m", "m_s", "v", "v_s"), (*_q8(m), *_q8(v))):
                    mom[k].copy_(x)

        for p, g, mom in zip(tree.leaves(params), tree.leaves(grads),
                             tree.leaves(state["mom"], is_leaf=_is_mom)):
            upd(p, g, mom)
        state["count"].fill_(t)
        return params, state

    return Optimizer(init, update)


def _is_mom(x) -> bool:
    return isinstance(x, dict) and "m" in x and "v" in x
