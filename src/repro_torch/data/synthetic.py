"""Deterministic synthetic datasets with matched shapes and statistics.

Counterpart of ``repro.data.synthetic``. The paper's datasets are not
downloadable offline, so training runs on structured synthetic data of the
same shape:

  * images: class templates plus Gaussian noise, in about [-1, 1];
  * MFCC-like features: a per-class frequency signature and time drift plus
    white noise;
  * token streams: a bigram process, so an LM's loss can fall well below
    uniform.

Everything is drawn from ``core.prng`` keys, on the key's device. Labels
and tokens come from :func:`prng.randint`, bit for bit the reference's; the
normals from :func:`prng.normal`, which differ from jax's by a few ulp in
~5% of draws (ROADMAP C4).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import prng


def make_image_dataset(key: torch.Tensor, *, n: int,
                       shape: Tuple[int, int, int], num_classes: int,
                       noise: float = 0.35, template_seed: int = 7):
    """``(images (N, H, W, C) in about [-1, 1], labels (N,) int64)``.

    The class templates come from ``template_seed`` (fixed, so splits drawn
    with different keys share their classes); ``key`` varies the labels
    and the per-sample noise.
    """
    k2, k3 = prng.split(key, 2)
    templates = prng.normal(prng.PRNGKey(template_seed, device=key.device),
                            (num_classes,) + tuple(shape)) * 0.8
    labels = prng.randint(k2, (n,), 0, num_classes)
    x = templates[labels] + noise * prng.normal(k3, (n,) + tuple(shape))
    return torch.clamp(x, -2.0, 2.0) * 0.5, labels


def make_mfcc_dataset(key: torch.Tensor, *, n: int, seq_len: int,
                      n_mfcc: int, num_classes: int, noise: float = 0.4,
                      template_seed: int = 11):
    """``(features (N, T, F), labels (N,) int64)``: a per-class
    time-frequency signature plus white noise, the signatures pinned to
    ``template_seed``."""
    kt1, kt2 = prng.split(prng.PRNGKey(template_seed, device=key.device))
    k2, k3 = prng.split(key, 2)
    sig = prng.normal(kt1, (num_classes, 1, n_mfcc))
    drift = prng.normal(kt2, (num_classes, seq_len, 1)) * 0.3
    labels = prng.randint(k2, (n,), 0, num_classes)
    x = sig[labels] + drift[labels] + noise * prng.normal(
        k3, (n, seq_len, n_mfcc))
    return x, labels


def make_bigram_stream(key: torch.Tensor, *, n_seqs: int, seq_len: int,
                       vocab: int, branch: int = 4, table_seed: int = 42):
    """Bigram token streams: ``(n_seqs, seq_len + 1)`` int32 tokens
    (inputs ``[:, :-1]``, labels ``[:, 1:]``), bit for bit the reference's.

    Each token maps to ``branch`` successors (a table drawn from
    ``table_seed``, fixed across batches); the chain picks among them at
    random. ``key`` draws the first tokens and the choices. The reference's
    scan over positions is a loop here, vectorised over the sequences.
    """
    k2, k3 = prng.split(key, 2)
    succ = prng.randint(prng.PRNGKey(table_seed, device=key.device),
                        (vocab, branch), 0, vocab)
    tok = prng.randint(k2, (n_seqs,), 0, vocab)
    choices = prng.randint(k3, (n_seqs, seq_len), 0, branch)
    out = torch.empty((n_seqs, seq_len + 1), dtype=torch.int64,
                      device=key.device)
    out[:, 0] = tok
    flat = succ.reshape(-1)
    for t in range(seq_len):
        tok = flat[tok * branch + choices[:, t]]
        out[:, t + 1] = tok
    return out.to(torch.int32)


def lm_batch(key: torch.Tensor, *, batch: int, seq_len: int, vocab: int):
    """One ``{"tokens", "labels"}`` batch of bigram data, (batch, seq_len)
    int32 each."""
    toks = make_bigram_stream(key, n_seqs=batch, seq_len=seq_len,
                              vocab=vocab)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
