"""A deterministic, coordinator-free data loader: counterpart of
``repro.data.loader``.

Every host derives its slice of the global batch from (step, host_id,
n_hosts) alone, so a restarted host resumes mid-epoch from the step in the
checkpoint's manifest. ``shard_batch`` (placing a batch on a mesh) comes
with the mesh slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import torch

from ..core import prng
from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class LoaderConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0


def batch_key(seed: int, step: int, *,
              device: DeviceLike = None) -> torch.Tensor:
    """The batch's key, ``fold_in(PRNGKey(seed), step)``: a pure function of
    (seed, step), so every host agrees. On ``device`` (CUDA unless the CPU
    is asked for)."""
    return prng.fold_in(prng.PRNGKey(seed, device=resolve_device(device)),
                        step)


class SyntheticLMLoader:
    """Deterministic bigram-stream loader (``data.synthetic.lm_batch``);
    batches are made on ``device`` (CUDA unless the CPU is asked for)."""

    def __init__(self, cfg: LoaderConfig, make_batch: Callable, *,
                 device: DeviceLike = None):
        self.cfg = cfg
        self._make = make_batch
        self.device = resolve_device(device)

    def batch_at(self, step: int):
        return self._make(batch_key(self.cfg.seed, step, device=self.device),
                          batch=self.cfg.global_batch,
                          seq_len=self.cfg.seq_len, vocab=self.cfg.vocab)

    def __iter__(self) -> Iterator:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def host_slice(global_batch: int, host_id: int, n_hosts: int) -> slice:
    """Contiguous per-host slice of the global batch (multi-host layout)."""
    per = global_batch // n_hosts
    return slice(host_id * per, (host_id + 1) * per)
