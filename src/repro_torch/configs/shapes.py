"""The four LM input shapes and (arch x shape) applicability.

Counterpart of ``repro.configs.shapes``:

train_4k     -> a training step   (tokens + labels, full batch)
prefill_32k  -> ``prefill``       (a prompt pass filling a KV cache)
decode_32k   -> the serve step    (ONE new token, a cache of seq_len)
long_500k    -> the serve step at 524288; needs sub-quadratic decode state
                (SSM / hybrid-local), so pure full-attention archs skip it.

``input_specs`` gives each step's inputs as ``meta`` tensors: shapes and
dtypes, no storage (the reference's ``ShapeDtypeStruct`` stand-ins).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..models import frontends
from ..models.transformer import TransformerConfig, cache_struct


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def applicable(cfg: TransformerConfig, shape: ShapeSpec
               ) -> Tuple[bool, str]:
    """(runs?, reason). The only skip rule: long_500k needs sub-quadratic
    attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500k dense-KV decode is "
                       "quadratic-history, outside this model family "
                       "(DESIGN.md §Arch-applicability)")
    return True, ""


def _ints(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _token_batch(cfg: TransformerConfig, batch: int, seq: int, *,
                 labels: bool) -> dict:
    """The inputs of one forward / train step."""
    n_vis = 0
    specs = {}
    if cfg.frontend.enabled:
        if not cfg.enc_dec:   # VLM: patch embeddings take the first slots
            n_vis = cfg.frontend.n_positions
        specs["feats"] = frontends.feature_spec(cfg.frontend, batch)
    s_text = seq - n_vis
    specs["tokens"] = _ints(batch, s_text)
    if labels:
        specs["labels"] = _ints(batch, s_text)
    return specs


def input_specs(cfg: TransformerConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins for every input of the step of ``shape.kind``:
      train   -> {"batch": {...tokens / labels / feats}}
      prefill -> {"batch": {...tokens / feats}}
      decode  -> {"caches": <cache tree>, "tokens": (B, 1)}
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": _token_batch(cfg, b, s, labels=True)}
    if shape.kind == "prefill":
        return {"batch": _token_batch(cfg, b, s, labels=False)}
    if shape.kind == "decode":
        return {"caches": cache_struct(cfg, b, s), "tokens": _ints(b, 1)}
    raise ValueError(shape.kind)
