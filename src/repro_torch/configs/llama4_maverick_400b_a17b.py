"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Maverick alternates dense and MoE layers (interleave=2); each MoE layer has
one always-on shared expert beside the 128 routed top-1 experts — this is
what makes 48L x (128e, d_ff 8192) land at ~400B total / ~17B active.
Early-fusion multimodality is a STUB per the assignment ([moe] tag: the LM
shapes feed pure text; the vision adapter exists for the quickstart only).

Counterpart of ``repro.configs.llama4_maverick_400b_a17b``, dtypes as torch dtypes.
"""
from __future__ import annotations

import torch

from ..core.quant import QuantConfig
from ..models.moe import MoEConfig
from ..models.transformer import LayerSpec, TransformerConfig
from .base import ArchConfig

_MOE = MoEConfig(n_experts=128, top_k=1, d_expert=8192, n_shared=1,
                 capacity_factor=1.25)

CONFIG = TransformerConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    pattern=(LayerSpec(), LayerSpec(moe=_MOE)),   # dense / MoE alternating
    rope_theta=500000.0,
    param_dtype=torch.bfloat16,
)

SMOKE = TransformerConfig(
    name="llama4-smoke",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    head_dim=16,
    pattern=(LayerSpec(),
             LayerSpec(moe=MoEConfig(8, 1, 128, n_shared=1))),
    param_dtype=torch.float32,
    max_seq=128,
)


def get() -> ArchConfig:
    return ArchConfig(
        arch_id="llama4-maverick-400b-a17b",
        model=CONFIG,
        smoke=SMOKE,
        mode="fsdp_tp",
        qcfg=QuantConfig(8, 8),
        grad_accum=8,
        notes="MoE top-1; shared expert; dense/MoE interleave=2; "
              "early-fusion frontend stubbed (LM shapes are text-only).",
    )
