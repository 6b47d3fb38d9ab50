"""Deterministic synthetic datasets with matched shapes and statistics.

Counterpart of the vision and audio parts of ``repro.data.synthetic`` (the
bigram token streams wait for the LM port). The paper's datasets are not
downloadable offline, so training runs on structured synthetic data of the
same shape:

  * images: class templates plus Gaussian noise, in about [-1, 1];
  * MFCC-like features: a per-class frequency signature and time drift plus
    white noise.

Everything is drawn from ``core.prng`` keys, on the key's device. Labels
come from :func:`prng.randint`, bit for bit the reference's; the normals
from :func:`prng.normal`, which differ from jax's by a few ulp in ~5% of
draws (ROADMAP C4).
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
