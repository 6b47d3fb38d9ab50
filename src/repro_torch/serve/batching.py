"""Continuous batching over fixed decode slots (counterpart of
``repro.serve.batching``).

The decode step has a fixed batch of ``slots`` lanes. Requests queue; a free
slot is filled as soon as one is free; a finished slot (EOS or its token
budget spent) retires and refills without changing the batch's shape: a
dead lane keeps flowing through the step, masked, not resized. Each
admitted prompt is prefilled into a fresh single-slot cache, which is then
written into the slot's rows of the batch cache (O(prompt) work, no
full-batch refill).

The model interface is ``prefill_fn(params, tokens)``, ``step_fn(params,
caches, tokens)`` and ``init_caches_fn(batch)``. They default to the float
transformer (``models.transformer``: ``prefill`` into a fresh single-slot
cache, ``decode.make_serve_step``, ``init_caches`` on the params' device);
``models.fq_lm.serve_fns`` gives the integer LM's (int8 code-domain KV
cache, per-slot positions). Either way the step writes the caches in place,
where the reference donates them, and runs eagerly.

Draws: one key per sampling event, ``fold_in(PRNGKey(0), n)`` with n the
count of draws so far (each admission and each decode step), as the
reference's ``_next_key``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from ..core import prng
from ..core.quant import QuantConfig
from ..models import transformer as T
from .decode import SampleConfig, make_serve_step, sample


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list            # token ids
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else tree
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


class ContinuousBatcher:
    """The reference's single-host batcher, on the caches' device.

    Each admitted prompt is prefilled alone, its first token sampled from
    the prefill logits; a request done at prefill (EOS, or ``max_new`` 1)
    retires before any batch state is touched. All live slots then decode
    in lockstep; retired lanes get token 0 and budget 0. The float
    transformer's caches share one scalar position counter, so concurrent
    requests need prompts of equal length; caches that carry per-slot
    position vectors (the integer LM's) admit staggered prompts. The token
    budgets are kept on the host.
    """

    def __init__(self, params, model_cfg, qcfg: QuantConfig, *, slots: int,
                 max_len: int, eos_id: int = -1,
                 sc: SampleConfig = SampleConfig(),
                 prefill_fn: Optional[Callable] = None,
                 step_fn: Optional[Callable] = None,
                 init_caches_fn: Optional[Callable] = None):
        defaults = None in (prefill_fn, step_fn, init_caches_fn)
        if defaults and not isinstance(model_cfg, T.TransformerConfig):
            raise TypeError(
                "ContinuousBatcher's default model functions serve the float "
                f"transformer (a TransformerConfig), not {type(model_cfg)}; "
                "pass prefill_fn, step_fn and init_caches_fn (the integer "
                "LM's: models.fq_lm.serve_fns)")
        if prefill_fn is None:
            def prefill_fn(params, toks):
                return T.prefill(params, {"tokens": toks}, model_cfg, qcfg,
                                 max_len=max_len)
        if step_fn is None:
            step_fn = make_serve_step(model_cfg, qcfg)
        if init_caches_fn is None:
            device = _first_tensor(params).device

            def init_caches_fn(batch):
                return T.init_caches(model_cfg, batch, max_len, device=device)
        self.params = params
        self.cfg = model_cfg
        self.qcfg = qcfg
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.sc = sc
        self._prefill = prefill_fn
        self._step = step_fn
        self.caches = init_caches_fn(slots)
        self.device = _first_tensor(self.caches).device
        self.active: List[Optional[Request]] = [None] * slots
        self.cur_tok = torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device)
        self.budget = [0] * slots
        self._key = prng.PRNGKey(0)
        self._draws = 0
        self._queue: List[Request] = []

    def _next_key(self):
        """A fresh key per sampling event: the draw counter folded into
        the base key, so that same-pass admissions and the next step never
        share a stream."""
        k = prng.fold_in(self._key, self._draws)
        self._draws += 1
        return k

    # -- slot management ----------------------------------------------------

    def _put(self, batch, one, slot):
        """Write the single-slot ``one`` into lane ``slot`` of ``batch``, in
        place: the batch axis is where ``batch`` has ``slots`` and ``one``
        has 1; a leaf of equal shape (a shared counter) is replaced."""
        if isinstance(batch, dict):
            return {k: self._put(batch[k], one[k], slot) for k in batch}
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._put(b, o, slot)
                               for b, o in zip(batch, one))
        if batch.shape == one.shape:
            return one
        for ax in range(one.dim()):
            if (one.shape[ax] == 1 and batch.shape[ax] == self.slots
                    and one.shape[:ax] == batch.shape[:ax]
                    and one.shape[ax + 1:] == batch.shape[ax + 1:]):
                batch.select(ax, slot).copy_(one.squeeze(ax))
                return batch
        return one

    def _admit(self, req: Request, slot: int):
        toks = torch.tensor([list(req.prompt)], dtype=torch.int32,
                            device=self.device)
        logits, fresh = self._prefill(self.params, toks)
        tok = sample(self._next_key(), logits, self.sc)
        first = int(tok[0, 0])
        # the prefill logits already gave the first output token
        req.out.append(first)
        if first == self.eos_id or req.max_new <= 1:
            # done at prefill: retire before any batch state is touched,
            # so the free lane carries none of this request
            req.done = True
            return
        self.caches = self._put(self.caches, fresh, slot)
        self.cur_tok[slot] = tok[0]
        self.budget[slot] = req.max_new - 1
        self.active[slot] = req

    def submit(self, reqs: List[Request]):
        self._queue.extend(reqs)

    def _fill_slots(self):
        for i in range(self.slots):
            if self.active[i] is None and self._queue:
                self._admit(self._queue.pop(0), i)

    # -- main loop ----------------------------------------------------------

    def step(self) -> int:
        """One decode step over all active slots; returns #active."""
        self._fill_slots()
        if not any(r is not None for r in self.active):
            return 0
        logits, self.caches = self._step(self.params, self.caches,
                                         self.cur_tok)
        nxt = sample(self._next_key(), logits, self.sc)
        self.cur_tok = nxt
        self.budget = [max(b - 1, 0) for b in self.budget]
        toks = nxt[:, 0].tolist()
        n_active = 0
        retired = []
        for i, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(toks[i])
            if toks[i] == self.eos_id or self.budget[i] <= 0:
                req.done = True
                self.active[i] = None
                retired.append(i)
            else:
                n_active += 1
        # zero the retired lanes: a dead lane keeps flowing through the
        # step, and its token and budget should not depend on whichever
        # request died there last
        for i in retired:
            self.cur_tok[i] = 0
            self.budget[i] = 0
        return n_active

    def run(self, reqs: List[Request], max_steps: int = 10_000
            ) -> Dict[int, list]:
        self.submit(reqs)
        for _ in range(max_steps):
            if self.step() == 0 and not self._queue:
                break
        return {r.rid: r.out for r in reqs}
