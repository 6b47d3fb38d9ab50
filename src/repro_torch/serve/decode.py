"""Sampling on the last-token logits and the float transformer's serve
step and generate loop (counterpart of ``repro.serve.decode``).

Greedy (temperature 0) is the argmax, the first maximum in both frameworks.
Sampled decoding is ``jax.random.categorical`` in jax 0.9's default "low"
mode, ``argmax(logits + gumbel)``, with the Gumbel draws the reference's
bit for bit: ``-log(-log(u))`` of ``uniform(key, minval=tiny, maxval=1)``
(``core.prng.uniform``) through ``core.quant.log``, XLA's float32 log. The
temperature divides tensor by tensor (CUDA turns a division by a Python
number into a reciprocal multiply); top-k keeps the logits at or above the
k-th largest (``torch.topk``) and sets the rest to -1e30.

``make_serve_step`` and ``generate`` serve the float transformer
(``models.transformer``): the step is ``decode_step`` writing the caches it
is given (the reference donates them), and ``generate`` is the reference's
host loop, a prefill then ``max_new`` steps, the key folded with the step's
index before each draw. ``cache_specs`` and ``jit_serve_step`` place caches
and params on a mesh and wait for the mesh slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import prng, quant
from ..core.quant import QuantConfig
from ..models import transformer as T

_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    temperature: float = 0.0
    top_k: int = 0


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in "low" mode: -log(-log(u)), u
    uniform in [tiny, 1), float32, on the key's device."""
    u = prng.uniform(key, shape, _TINY, 1.0)
    return -quant.log(-quant.log(u))


def sample(key, logits: torch.Tensor, sc: SampleConfig) -> torch.Tensor:
    """logits (B, T, V) -> tokens (B, 1) int32 from the last position."""
    lg = logits[:, -1].to(torch.float32)
    if sc.temperature <= 0.0:
        return torch.argmax(lg, -1, keepdim=True).to(torch.int32)
    f32 = dict(dtype=torch.float32, device=lg.device)
    lg = torch.div(lg, torch.tensor(sc.temperature, **f32))
    if sc.top_k > 0:
        kth = torch.topk(lg, sc.top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.tensor(-1e30, **f32), lg)
    g = gumbel(key.to(lg.device), tuple(lg.shape))
    return torch.argmax(g + lg, -1, keepdim=True).to(torch.int32)


def make_serve_step(model_cfg, qcfg: QuantConfig):
    """serve_step(params, caches, tokens) -> (logits, caches): one decode
    step of every slot, the caches written in place."""

    def step(params, caches, tokens):
        return T.decode_step(params, caches, tokens, model_cfg, qcfg)

    return step


def generate(params, model_cfg, qcfg, prompt_batch, *, max_new: int,
             sc: SampleConfig = SampleConfig(), seed: int = 0,
             max_len: Optional[int] = None):
    """The host-side generate loop (prefill, then greedy or sampled decode)
    on the prompt's device. Returns (B, max_new) int32 tokens."""
    s = prompt_batch["tokens"].shape[1]
    if model_cfg.frontend.enabled and not model_cfg.enc_dec:
        s += model_cfg.frontend.n_positions
    max_len = max_len or (s + max_new)
    logits, caches = T.prefill(params, prompt_batch, model_cfg, qcfg,
                               max_len=max_len)
    step = make_serve_step(model_cfg, qcfg)
    key = prng.PRNGKey(seed).to(logits.device)
    out = []
    tok = sample(key, logits, sc)
    for i in range(max_new):
        out.append(tok)
        logits, caches = step(params, caches, tok)
        key = prng.fold_in(key, i)
        tok = sample(key, logits, sc)
    return torch.cat(out, dim=1)
